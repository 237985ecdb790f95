"""yi-34b [dense] — llama-architecture GQA. [arXiv:2403.04652; hf]

Assigned: 60L d_model=7168 56H (kv=8) d_ff=20480 vocab=64000.
TP=16: Q heads padded 56->64 (zero-masked), KV logical 8 (activation-replicated).
"""
import torch
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000,
        rope_theta=5e6, tp=16, remat="full",
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, d_model=64, n_heads=7, n_kv_heads=1,
                        d_ff=160, vocab=128, head_dim=16, tp=1, remat="none",
                        param_dtype=torch.float32, compute_dtype=torch.float32)
