"""llama4-maverick-400b-a17b [moe] — MoE top-1 + shared expert, interleaved
dense/MoE layers, iRoPE chunked-local/global attention.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Assigned: 48L d_model=5120 40H (kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
Interleave: every 2nd layer MoE (matches the 400B total / 17B active headline
with 128 experts of d_ff 8192); every 4th layer global attention, others
chunked-local (8192). Global layers make long_500k inapplicable (skipped).
bf16 params + factored optimizer for memory at 512 chips.
"""
import torch
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
        d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
        head_dim=128, attn_type="chunked_interleaved", chunk=8192,
        global_every=4, n_experts=128, top_k=1, moe_interleave=2,
        shared_expert=True, moe_impl="ep", rope_theta=5e5,
        param_dtype=torch.bfloat16, tp=16, remat="full",
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=128, head_dim=16, chunk=8,
                        n_experts=4, moe_impl="dense", tp=1, remat="none",
                        param_dtype=torch.float32, compute_dtype=torch.float32)
