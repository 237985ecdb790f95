"""olmo-1b [dense] — non-parametric LayerNorm. [arXiv:2402.00838; hf]

Assigned: 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304.
"""
import torch
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense", n_layers=16, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=8192, vocab=50304,
        norm="nonparam_ln", mlp_type="swiglu", rope_theta=1e4,
        tp=16, remat="full",
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=128, vocab=128, tp=1, remat="none",
                        param_dtype=torch.float32, compute_dtype=torch.float32)
