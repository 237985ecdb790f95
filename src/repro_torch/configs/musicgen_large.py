"""musicgen-large [audio] — decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]

Assigned: 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.
The EnCodec frontend is a STUB per the assignment: input_specs supplies
pre-computed frame embeddings (the 4 codebook embeddings summed); the head
predicts codebook-0 tokens over the 2048-entry codebook. GELU MLP (musicgen
uses a standard non-gated transformer FFN). Full attention -> long_500k skip.
"""
import torch
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab=2048,
        mlp_type="gelu", frontend="frames", n_codebooks=4,
        rope_theta=1e4, tp=16, remat="full",
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=128, vocab=64, tp=1, remat="none",
                        param_dtype=torch.float32, compute_dtype=torch.float32)
