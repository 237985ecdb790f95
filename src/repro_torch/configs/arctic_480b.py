"""arctic-480b [moe] — 128 experts top-2 + parallel dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]

Assigned: 35L d_model=7168 56H (kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
Dense-MoE hybrid: a d_ff=7168 dense MLP runs in parallel with the routed
experts on every layer (~10B dense + ~470B expert params = 480B headline).
bf16 params + factored optimizer for memory at 512 chips.
"""
import torch
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe", n_layers=35, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000,
        n_experts=128, top_k=2, moe_interleave=1, dense_residual_ff=7168,
        moe_impl="ep", rope_theta=1e6,
        param_dtype=torch.bfloat16, tp=16, remat="full",
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, d_model=64, n_heads=7, n_kv_heads=1,
                        d_ff=64, vocab=128, head_dim=16, n_experts=4,
                        dense_residual_ff=64, moe_impl="dense", tp=1,
                        remat="none",
                        param_dtype=torch.float32, compute_dtype=torch.float32)
