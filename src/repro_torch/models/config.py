"""Unified model configuration covering all assigned architecture families.

Port of ``repro/models/config.py``: the same fields and properties, with
``torch.dtype``s for the parameter and compute types and the port's
``PhiConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.patterns import PhiConfig
from repro_torch.utils import ceil_to


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None

    # attention
    attn_type: str = "full"     # full | swa | chunked_interleaved | none
    window: int = 4096
    chunk: int = 8192
    global_every: int = 4       # chunked_interleaved: every Nth layer is global
    qkv_bias: bool = False
    norm: str = "rmsnorm"       # rmsnorm | nonparam_ln
    mlp_type: str = "swiglu"    # swiglu | gelu
    rope_theta: float = 1e6

    # moe
    n_experts: int = 0
    top_k: int = 1
    moe_interleave: int = 1     # every Nth layer is MoE (1 = all layers)
    shared_expert: bool = False
    dense_residual_ff: int = 0  # arctic-style parallel dense MLP width
    capacity_factor: float = 1.25
    moe_impl: str = "dense"     # dense | ep  (ep = shard_map all-to-all)

    # ssm (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_kernel: int = 4
    hybrid_attn_every: int = 0  # zamba2: shared attn block every N ssm layers

    # modality frontend stub
    frontend: str = "none"      # none | patches | frames
    frontend_positions: int = 0
    n_codebooks: int = 1        # musicgen codebook inputs (stubbed embeddings)

    # numerics / distribution
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    tp: int = 1                 # TP degree used for head padding
    remat: str = "full"         # none | full | dots
    scan_layers: bool = True
    attn_impl: str = "flash"    # flash (custom-vjp) | naive (autodiff blockwise)
    flash_block_q: int = 512
    flash_block_kv: int = 1024

    # spiking / Phi mode
    phi: PhiConfig | None = None
    spiking: bool = False

    # ---------------------------------------------------------- resolved ---
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def q_heads_padded(self) -> int:
        """Q heads zero-padded up to a multiple of the TP degree (exact math:
        padded heads have zero out-projection rows)."""
        return ceil_to(self.n_heads, self.tp)

    @property
    def kv_heads_padded(self) -> int:
        """KV heads replicated up to the TP degree when fewer (exact math:
        duplicated heads serve disjoint Q groups)."""
        if self.n_kv_heads >= self.tp:
            return ceil_to(self.n_kv_heads, self.tp)
        return self.tp

    @property
    def kv_rep(self) -> int:
        return self.kv_heads_padded // self.n_kv_heads

    @property
    def q_per_kv(self) -> int:
        return self.q_heads_padded // self.kv_heads_padded

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (per-assignment rule)."""
        return self.family in ("ssm", "hybrid") or self.attn_type == "swa"

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and (i % self.moe_interleave == self.moe_interleave - 1)

    def is_global_layer(self, i: int) -> bool:
        if self.attn_type != "chunked_interleaved":
            return self.attn_type == "full"
        return i % self.global_every == self.global_every - 1

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # rough parameter counts for MODEL_FLOPS (logical, unpadded)
    def param_count(self) -> tuple[float, float]:
        """(total_params, active_params) — logical, before TP padding."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        emb = V * d * 2  # embed + head (untied)
        if self.family in ("ssm",):
            inner = self.d_inner
            per = d * (2 * inner + 2 * self.ssm_state + self.ssm_heads) + inner * d + inner
            return emb + L * per, emb + L * per
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        gate = 3 if self.mlp_type == "swiglu" else 2
        mlp_dense = gate * d * ff
        if self.family == "hybrid":
            inner = self.d_inner
            per_ssm = d * (2 * inner + 2 * self.ssm_state + self.ssm_heads) + inner * d
            shared = attn + gate * d * ff
            n_sites = max(1, L // max(self.hybrid_attn_every, 1))
            tot = emb + L * per_ssm + shared + n_sites * 4 * d * 64  # + lora (r=64)
            return tot, tot
        if self.n_experts:
            n_moe = L // self.moe_interleave
            n_dense = L - n_moe
            expert = gate * d * ff
            moe_tot = n_moe * (self.n_experts * expert + d * self.n_experts)
            moe_act = n_moe * (self.top_k * expert + d * self.n_experts)
            if self.shared_expert:
                moe_tot += n_moe * expert
                moe_act += n_moe * expert
            dres = L * gate * d * self.dense_residual_ff if self.dense_residual_ff else 0
            base = emb + L * attn + n_dense * mlp_dense + dres
            return base + moe_tot, base + moe_act
        tot = emb + L * (attn + mlp_dense)
        return tot, tot
