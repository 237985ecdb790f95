"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]

Assigned: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
One shared transformer block (attention + MLP) is invoked after every 6
mamba2 layers with per-site LoRA (r=64) on the Q projection; 38 = 6×6 + 2
tail mamba layers. Sub-quadratic -> long_500k runs.
"""
import torch
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32000,
        ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
        hybrid_attn_every=6, rope_theta=1e4, tp=16, remat="full",
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=128, vocab=128, ssm_state=16, ssm_headdim=16,
                        ssm_chunk=8, hybrid_attn_every=2, tp=1, remat="none",
                        param_dtype=torch.float32, compute_dtype=torch.float32)
