"""Mamba-2 (state-space duality) block: chunked SSD prefill and recurrent
decode. Port of ``repro/models/mamba2.py`` (arXiv:2405.21060).

The chunked algorithm computes the intra-chunk terms as (Q × Q) matmuls and
carries the inter-chunk SSM states with a short sequential recurrence over
S / chunk chunks; the reference's ``lax.scan`` over chunks is a loop here,
in float32, and every other contraction is the reference's einsum.

The fused in_proj is split into per-quantity weights (wz / wx / wB / wC /
wdt), as in the reference; every GEMM goes through the injected ``matmul``
under those names, so Phi spiking mode reaches each of them through
``model.make_matmul``. The SSD, the convolutions, the norm and the gate are
plain PyTorch: the reference has no TPU kernel there.

On a mesh (``sharding.use_rules``) a rank runs its block of the SSM heads,
read from the local widths as the attention blocks read their Q heads:
``wz``, ``wx`` and ``wdt`` are column-parallel, ``conv_x``, ``A_log``,
``D``, ``dt_bias`` and ``norm_w`` hold the rank's heads, and ``wB``,
``wC``, ``conv_B`` and ``conv_C`` are whole on every rank (``B`` and ``C``
are one group shared by all heads), so their outputs' gradients are summed
over the heads' axis. The SSD, the decode recurrence, the conv rings and the
SSM states are the rank's. The gated norm spans ``d_inner``: a rank gathers
its rows' ``y`` over the heads' axis and norms each row whole, in one
device's order, keeping its block. The decode step's read of the state
(a contraction over the state dim) is made in one device's call shape, as
``layers.one_device_call`` makes attention's. ``wo`` is row-parallel, its
partial products summed by the matmul (``models.model``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (
    ParamSpec, batch_rows, current_mesh, resolve_spec, shard)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import default_mm, one_device_call, rmsnorm


def mamba_specs(cfg: ModelConfig, layers: int | None = None) -> dict:
    d, inner, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    kc = cfg.conv_kernel
    L = () if layers is None else (layers,)
    A = () if layers is None else ("layers",)
    dt = cfg.param_dtype
    return {
        "wz": ParamSpec(L + (d, inner), A + ("fsdp", "heads"), dt),
        "wx": ParamSpec(L + (d, inner), A + ("fsdp", "heads"), dt),
        "wB": ParamSpec(L + (d, N), A + ("fsdp", "state"), dt),
        "wC": ParamSpec(L + (d, N), A + ("fsdp", "state"), dt),
        "wdt": ParamSpec(L + (d, H), A + ("fsdp", "heads"), dt),
        "conv_x": ParamSpec(L + (kc, inner), A + ("conv", "heads"), dt, scale=0.5),
        "conv_B": ParamSpec(L + (kc, N), A + ("conv", "state"), dt, scale=0.5),
        "conv_C": ParamSpec(L + (kc, N), A + ("conv", "state"), dt, scale=0.5),
        "A_log": ParamSpec(L + (H,), A + ("heads",), torch.float32, init="zeros"),
        "D": ParamSpec(L + (H,), A + ("heads",), torch.float32, init="ones"),
        "dt_bias": ParamSpec(L + (H,), A + ("heads",), torch.float32, init="zeros"),
        "norm_w": ParamSpec(L + (inner,), A + ("heads",), dt, init="ones"),
        "wo": ParamSpec(L + (inner, d), A + ("heads", "fsdp"), dt),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, activation: bool = True) -> torch.Tensor:
    """Depthwise causal conv. x (B,S,C), w (k,C)."""
    k = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, [0, 0, k - 1, 0])
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, k):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    return F.silu(y) if activation else y


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise decay sums: out[..., i, j] = Σ_{j<s<=i} dA[s]."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, -1)
    diff = cs[..., :, None] - cs[..., None, :]                 # (..., i, j)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """SSD over a sequence. Returns (y, final_state).

    x (B,S,H,P); dt (B,S,H) post-softplus; A (H,) negative;
    Bm/Cm (B,S,N) (single group broadcast over heads).
    """
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    f32 = torch.float32
    xc = x.reshape(Bb, nc, chunk, H, P)
    dtc = dt.reshape(Bb, nc, chunk, H)
    Bc = Bm.reshape(Bb, nc, chunk, N).to(f32)
    Cc = Cm.reshape(Bb, nc, chunk, N).to(f32)
    dA = (dtc * A[None, None, None, :]).to(f32)               # (B,nc,Q,H) <= 0
    dA = dA.movedim(-1, 2)                                     # (B,nc,H,Q)
    dA_cum = torch.cumsum(dA, -1)                              # (B,nc,H,Q)
    xdt = (xc * dtc[..., None]).to(f32)                        # (B,nc,Q,H,P)

    # Intra-chunk (attention-like):
    Lmat = torch.exp(_segsum(dA))                              # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)           # (B,nc,Q,Q)
    att = scores[:, :, None] * Lmat                            # (B,nc,H,Q,Q)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", att, xdt)

    # Per-chunk input states:
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)        # (B,nc,H,Q)
    states = torch.einsum("bckn,bchk,bckhp->bchpn", Bc, decay_states, xdt)

    # Inter-chunk recurrence (sequential over nc chunks):
    chunk_decay = torch.exp(dA_cum[..., -1])                   # (B,nc,H)
    s = torch.zeros((Bb, H, P, N), dtype=f32, device=x.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prevs = torch.stack(s_prevs, 1)                          # (B,nc,H,P,N)

    y_off = torch.einsum("bcqn,bchpn,bchq->bcqhp", Cc, s_prevs, torch.exp(dA_cum))
    y = (y_diag + y_off).reshape(Bb, S, H, P)
    return y.to(x.dtype), s


def ssd_chunk(S: int, chunk: int) -> int:
    """The largest divisor of S not exceeding the configured chunk."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def _heads_axis(cfg: ModelConfig, inner: int):
    """The mesh axes a rank's block of ``inner`` of the ``d_inner`` channels
    is cut over (None where it holds them all)."""
    if inner == cfg.d_inner:
        return None
    if current_mesh() is None:
        raise ValueError(f"{inner} of {cfg.d_inner} SSM channels outside a mesh")
    return resolve_spec(("heads",))[0]


def _shared_group(cfg: ModelConfig, inner: int, *ts: torch.Tensor) -> tuple:
    """``B`` and ``C``, whole on every rank, feed only the rank's heads:
    their gradients are summed over the heads' axis (identity off a mesh and
    off autograd)."""
    ax = _heads_axis(cfg, inner)
    return tuple(coll.sum_grad(t, current_mesh(), ax) for t in ts)


def _gated_norm(cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
                norm_w: torch.Tensor) -> torch.Tensor:
    """``rmsnorm(y, norm_w) * silu(z)`` over ``d_inner``. A rank holding a
    block of the channels gathers its rows over the heads' axis and norms
    each row whole (partial sums of squares summed across ranks would round
    in another order than one device's), keeping its block."""
    gate = F.silu(z.to(torch.float32)).to(y.dtype)
    ax = _heads_axis(cfg, y.shape[-1])
    if ax is None:
        return rmsnorm(y, norm_w) * gate
    mesh = current_mesh()
    xf = coll.all_gather(y, mesh, ax, dim=-1).to(torch.float32)
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)     # as rmsnorm's
    c0 = mesh.index(ax) * y.shape[-1]
    return (xf[..., c0:c0 + y.shape[-1]] * r * norm_w.to(torch.float32)).to(y.dtype) * gate


def mamba_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor, matmul=None):
    """x (B,S,D) -> (y (B,S,D), (ssm_state, conv_states)). On a mesh, the
    rank's heads (see the module docstring)."""
    mm = matmul or default_mm
    B, S, _ = x.shape
    z = mm(x, p, "wz")
    x_pre = mm(x, p, "wx")
    B_pre = mm(x, p, "wB")
    C_pre = mm(x, p, "wC")
    dt = mm(x, p, "wdt").to(torch.float32)
    P = cfg.ssm_headdim
    H = x_pre.shape[-1] // P                       # this rank's heads
    xin = shard(causal_conv1d(x_pre, p["conv_x"]), "batch", "seq", "act_heads")
    Bm, Cm = _shared_group(cfg, x_pre.shape[-1], causal_conv1d(B_pre, p["conv_B"]),
                           causal_conv1d(C_pre, p["conv_C"]))
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(B, S, H, P)
    y, state = ssd_chunked(xh, dt, A, Bm, Cm, ssd_chunk(S, cfg.ssm_chunk))
    y = y + p["D"][None, None, :, None].to(y.dtype) * xh
    y = _gated_norm(cfg, y.reshape(B, S, H * P), z, p["norm_w"])
    out = mm(y, p, "wo")
    # conv ring states for the decode handoff: the last (k-1) pre-conv inputs
    kc = cfg.conv_kernel
    conv_states = {"x": x_pre[:, S - (kc - 1):], "B": B_pre[:, S - (kc - 1):],
                   "C": C_pre[:, S - (kc - 1):]}
    return shard(out, "batch", "seq", "act_embed"), (state, conv_states)


def _conv_decode(x_t: torch.Tensor, state: torch.Tensor, w: torch.Tensor, activation=True):
    """x_t (B,C); state (B,k-1,C) past inputs. Returns (y_t, new_state)."""
    full = torch.cat([state, x_t[:, None]], 1)                 # (B,k,C)
    y = (full * w[None].to(full.dtype)).sum(1)
    new_state = full[:, 1:]
    return (F.silu(y) if activation else y), new_state


def _read_state(cfg: ModelConfig, Cm: torch.Tensor, ssm: torch.Tensor) -> torch.Tensor:
    """y (B,H,P) = Σ_n Cm (B,N) · ssm (B,H,P,N). The library's contraction
    rounds differently at other row and head counts (on the card), so on a
    mesh a rank makes one device's call (``layers.one_device_call``, heads on
    axis 1; ``Cm`` has none)."""
    def read(s, c):
        return torch.einsum("bn,bhpn->bhp", c, s)

    if current_mesh() is None:
        return read(ssm, Cm)
    b, h = ssm.shape[:2]
    R, r0 = batch_rows() or (b, 0)
    ax = _heads_axis(cfg, h * cfg.ssm_headdim)
    h0 = 0 if ax is None else current_mesh().index(ax) * h
    return one_device_call(read, (R, r0, cfg.ssm_heads, h0), ssm, rows_only=Cm, head_axis=1)


def mamba_decode(cfg: ModelConfig, p: dict, x_t: torch.Tensor, state, matmul=None):
    """One-token recurrent step. x_t (B,D); state = (ssm (B,H,P,N), conv dict).
    Returns (out, new state); the caller writes the new state where it keeps it.
    On a mesh, the rank's heads and its rows' state."""
    mm = matmul or default_mm
    ssm, conv = state
    B = x_t.shape[0]
    f32 = torch.float32
    z = mm(x_t, p, "wz")
    xin, cx = _conv_decode(mm(x_t, p, "wx"), conv["x"], p["conv_x"])
    Bm, cB = _conv_decode(mm(x_t, p, "wB"), conv["B"], p["conv_B"])
    Cm, cC = _conv_decode(mm(x_t, p, "wC"), conv["C"], p["conv_C"])
    P = cfg.ssm_headdim
    H = xin.shape[-1] // P                         # this rank's heads
    Bm, Cm = _shared_group(cfg, xin.shape[-1], Bm, Cm)
    dt = F.softplus(mm(x_t, p, "wdt").to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                      # (B,H)
    xh = xin.reshape(B, H, P).to(f32)
    xdt = xh * dt[..., None]
    ssm_new = ssm * dA[..., None, None] + torch.einsum("bn,bhp->bhpn", Bm.to(f32), xdt)
    y = _read_state(cfg, Cm.to(f32), ssm_new)
    y = y + p["D"][None, :, None] * xh
    y = _gated_norm(cfg, y.reshape(B, H * P).to(x_t.dtype), z, p["norm_w"])
    out = mm(y, p, "wo")
    return out, (ssm_new, {"x": cx, "B": cB, "C": cC})


def mamba_state_specs(cfg: ModelConfig, batch: int, layers: int) -> dict:
    """Shapes and dtypes of a stack's decode state, by quantity."""
    from repro_torch.models.model import TensorSpec

    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    kc = cfg.conv_kernel
    inner = cfg.d_inner
    return {
        "ssm": TensorSpec((layers, batch, H, P, N), torch.float32),
        "conv_x": TensorSpec((layers, batch, kc - 1, inner), cfg.compute_dtype),
        "conv_B": TensorSpec((layers, batch, kc - 1, N), cfg.compute_dtype),
        "conv_C": TensorSpec((layers, batch, kc - 1, N), cfg.compute_dtype),
    }
