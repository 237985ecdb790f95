"""qwen1.5-4b [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]

Assigned: 40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936.
"""
import torch
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
        n_heads=20, n_kv_heads=20, d_ff=6912, vocab=151936,
        qkv_bias=True, rope_theta=1e6, tp=16, remat="full",
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=96, vocab=256, tp=1, remat="none",
                        param_dtype=torch.float32, compute_dtype=torch.float32)
