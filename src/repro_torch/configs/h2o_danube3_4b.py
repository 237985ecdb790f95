"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]

Assigned: 24L d_model=3840 32H (kv=8) d_ff=10240 vocab=32000. SWA window 4096
(mistral heritage) makes it sub-quadratic -> long_500k runs for this arch.
"""
import torch
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense", n_layers=24, d_model=3840,
        n_heads=32, n_kv_heads=8, d_ff=10240, vocab=32000,
        attn_type="swa", window=4096, rope_theta=1e4,
        tp=16, remat="full",
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=128, window=16, tp=1, remat="none",
                        param_dtype=torch.float32, compute_dtype=torch.float32)
