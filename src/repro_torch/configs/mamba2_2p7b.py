"""mamba2-2.7b [ssm] — SSD, attention-free. [arXiv:2405.21060; unverified]

Assigned: 64L d_model=2560 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
Standard mamba2 hyper-params: expand=2 (d_inner 5120), headdim 64 (80 heads),
conv kernel 4, chunk 128.
"""
import torch
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280, attn_type="none",
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
        tp=16, remat="full",
    )


def smoke() -> ModelConfig:
    return full().with_(n_layers=2, d_model=64, vocab=128, ssm_state=16,
                        ssm_headdim=16, ssm_chunk=8, tp=1, remat="none",
                        param_dtype=torch.float32, compute_dtype=torch.float32)
