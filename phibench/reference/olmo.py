"""Plain spiking OLMo forward (decoder-only, non-parametric LayerNorm, RoPE,
causal multi-head attention, SwiGLU MLP) in Phi spiking mode.

The configuration file states the arithmetic: parameters in float32,
activations in bfloat16, every decoder GEMM spiking. A GEMM operand is cast
to float32 and rate-coded into ``timesteps`` binary spike trains by an LIF
neuron over the operand repeated; each timestep's product with the float32
weight is summed in float32, averaged over the timesteps, multiplied by
2 · threshold and cast back to the activation dtype. Phi is lossless against
this spiking-dense product, so the reference needs no pattern banks.
Attention, norms and RoPE run in float32 on the bfloat16 activations and
return bfloat16, as stated. The head multiplies the bfloat16 final norm by
the bfloat16-rounded head weight in float32 and keeps float32 logits.

``gemm`` names the precision of the spiking GEMMs: "float32" is the stated
one; "bfloat16" a control (both operands and each timestep's product
rounded to bfloat16). ``act`` names the activations' precision: the
stated "bfloat16", or the control "float8_e4m3fn" (each activation rounded
through float8 e4m3 where the stated arithmetic rounds it to bfloat16).

Weights come as ``make_weights`` makes them: ``embed`` (V, d), ``head``
(d, V) and the per-layer stacks ``wq``, ``wk``, ``wv``, ``wo`` (L, d, d),
``w1``, ``w3`` (L, d, ff), ``w2`` (L, ff, d). ``check_program`` says whether
a program's model config computes this model at the file's sizes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from phibench.reference.spiking import exact_float32, lif_spikes, matmul

ACT = {"bfloat16": torch.bfloat16, "float32": torch.float32}
GRID = 1024.0


def make_weights(sizes: dict, seed: int, device) -> dict:
    """The model's weights from ``seed``, on ``device``: normal, 0.02 for the
    embedding and 1/sqrt(fan_in) elsewhere, rounded onto the 2^-10 grid."""
    L, d, ff, V = sizes["n_layers"], sizes["d_model"], sizes["d_ff"], sizes["vocab"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, scale):
        x = torch.randn(shape, generator=gen, device=device)
        return (x * (scale * GRID)).round_() / GRID

    w = {"embed": normal((V, d), 0.02), "head": normal((d, V), d ** -0.5)}
    for name in ("wq", "wk", "wv", "wo"):
        w[name] = normal((L, d, d), d ** -0.5)
    w["w1"] = normal((L, d, ff), d ** -0.5)
    w["w3"] = normal((L, d, ff), d ** -0.5)
    w["w2"] = normal((L, ff, d), ff ** -0.5)
    return w


def check_program(cfg, sizes: dict) -> None:
    """Raises unless the program's config ``cfg`` (read by attribute only)
    is this model at ``sizes``."""
    have = {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "rope_theta": cfg.rope_theta, "timesteps": cfg.phi.timesteps,
            "activation_dtype": str(cfg.compute_dtype).removeprefix("torch."),
            "param_dtype": str(cfg.param_dtype).removeprefix("torch.")}
    want = {k: sizes[k] for k in have}
    if have != want or cfg.norm != "nonparam_ln" or cfg.mlp_type != "swiglu":
        raise ValueError(f"the program's config {have} is not the file's {want}")


def caster(act: str):
    """The rounding of an activation to ``act``, kept in a dtype torch
    computes in (float8 values are carried in bfloat16)."""
    if act == "float8_e4m3fn":
        return lambda x: x.to(torch.float8_e4m3fn).to(torch.bfloat16)
    return lambda x: x.to(ACT[act])


def _spiking_mm(x: torch.Tensor, w: torch.Tensor, sizes: dict, gemm: str, cast) -> torch.Tensor:
    T = sizes["timesteps"]
    spikes = lif_spikes(x.to(torch.float32).unsqueeze(0).expand(T, *x.shape),
                        sizes["lif_decay"], sizes["lif_threshold"])
    out = torch.stack([matmul(spikes[t], w, gemm) for t in range(T)])
    return cast(out.mean(0) * (2.0 * sizes["lif_threshold"]))


def _layer_norm(x: torch.Tensor, eps: float, cast) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return cast((xf - mu) * torch.rsqrt(var + eps))


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float, cast) -> torch.Tensor:
    """x (S, H, D); positions (S,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[:, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return cast(torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1))


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_rows: int,
               cast) -> torch.Tensor:
    """Causal softmax attention of the last ``q_rows`` queries; q, k, v (S, H, D)."""
    S, H, D = k.shape
    qf = q[S - q_rows:].to(torch.float32).transpose(0, 1)                 # (H, r, D)
    kf, vf = (t.to(torch.float32).transpose(0, 1) for t in (k, v))        # (H, S, D)
    s = (qf @ kf.transpose(1, 2)) * D ** -0.5
    qpos = torch.arange(S - q_rows, S, device=q.device)
    kpos = torch.arange(S, device=q.device)
    s = torch.where((kpos[None, :] <= qpos[:, None])[None], s, -torch.inf)
    return cast((torch.softmax(s, -1) @ vf).transpose(0, 1))                # (r, H, D)


def logits(weights: dict, sizes: dict, tokens: torch.Tensor, first: int,
           gemm: str = "float32", act: str | None = None) -> torch.Tensor:
    """float32 logits (S - first, V) of positions first..S-1 of ``tokens`` (S,)."""
    cast = caster(act or sizes["activation_dtype"])
    H, d = sizes["n_heads"], sizes["d_model"]
    hd = d // H
    eps = sizes["ln_eps"]
    S = tokens.shape[0]
    positions = torch.arange(S, device=tokens.device)
    with exact_float32(), torch.no_grad():
        x = cast(weights["embed"][tokens.long()])
        for li in range(sizes["n_layers"]):
            def mm(a, name):
                return _spiking_mm(a, weights[name][li], sizes, gemm, cast)

            h = _layer_norm(x, eps, cast)
            q = _rope(mm(h, "wq").reshape(S, H, hd), positions, sizes["rope_theta"], cast)
            k = _rope(mm(h, "wk").reshape(S, H, hd), positions, sizes["rope_theta"], cast)
            v = mm(h, "wv").reshape(S, H, hd)
            o = _attention(q, k, v, S, cast)
            x = cast(x + mm(o.reshape(S, d), "wo"))
            h = _layer_norm(x, eps, cast)
            g = cast(F.silu(mm(h, "w1")) * mm(h, "w3"))
            x = cast(x + mm(g, "w2"))
        x = _layer_norm(x[first:], eps, cast)
        head = cast(weights["head"]).to(torch.float32)
        return x.to(torch.float32) @ head
