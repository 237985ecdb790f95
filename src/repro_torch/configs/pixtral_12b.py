"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

Assigned: 40L d_model=5120 32H (kv=8) d_ff=14336 vocab=131072.
The ViT frontend is a STUB per the assignment: input_specs supplies 256
pre-computed patch embeddings prepended to the text tokens.
"""
import torch
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131072,
        head_dim=128, rope_theta=1e9, frontend="patches",
        frontend_positions=256, tp=16, remat="full",
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, vocab=128, head_dim=16,
                        frontend_positions=4, tp=1, remat="none",
                        param_dtype=torch.float32, compute_dtype=torch.float32)
