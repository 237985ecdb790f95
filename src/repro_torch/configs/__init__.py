"""Architecture registry: one module per assigned arch (port of ``repro/configs``).

``get_config(name)`` returns the exact assigned full config;
``get_config(name, smoke=True)`` a reduced same-family config for CPU tests;
``phi_variant(cfg)`` the spiking+Phi serving variant of any config. Pure
data: every config comes across, including the families whose layers the
port does not run yet (``models/transformer.py`` refuses them).
"""
from __future__ import annotations

import importlib

from repro_torch.core.patterns import PhiConfig
from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "mamba2_2p7b",
    "olmo_1b",
    "h2o_danube3_4b",
    "yi_34b",
    "qwen1p5_4b",
    "pixtral_12b",
    "llama4_maverick",
    "arctic_480b",
    "zamba2_1p2b",
    "musicgen_large",
]

ALIASES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "olmo-1b": "olmo_1b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "yi-34b": "yi_34b",
    "qwen1.5-4b": "qwen1p5_4b",
    "pixtral-12b": "pixtral_12b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "arctic-480b": "arctic_480b",
    "zamba2-1.2b": "zamba2_1p2b",
    "musicgen-large": "musicgen_large",
}


def get_config(name: str, smoke: bool = False, **overrides) -> ModelConfig:
    """The config of arch ``name`` (an id or an alias): full, or its smoke cut."""
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg = mod.smoke() if smoke else mod.full()
    return cfg.with_(**overrides) if overrides else cfg


def phi_variant(cfg: ModelConfig, timesteps: int = 4, q: int = 128, k: int = 16,
                nnz_budget: float = 0.04) -> ModelConfig:
    """Spiking + Phi serving variant (the paper's technique applied).

    nnz_budget: static L2 capacity; paper-measured density is ~3%, +margin."""
    return cfg.with_(spiking=True,
                     phi=PhiConfig(k=k, q=q, timesteps=timesteps, nnz_budget=nnz_budget))
