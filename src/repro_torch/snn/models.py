"""Spiking models for the paper-side evaluation (VGG/ResNet/Spikformer family).

Plain functions on tensors (init/apply pairs), with the reference package's
layouts: NHWC images, HWIO conv weights, time-major (T, B, …) activations.
Every perf-critical matmul operand is a spike tensor; ``apply(...,
capture=...)`` also returns the binary activation matrices in GEMM layout
(rows × K), conv layers via im2col, which is what Phi calibration consumes.
``phi_apply`` runs inference with the calibrated Phi decomposition in place
of every spiking GEMM; without PAFT it is bit-exact with ``apply`` (the
paper's losslessness claim).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.patterns import (
    PhiConfig, active_pattern_sets, calibrate, pattern_usage, pattern_weight_products)
from repro_torch.kernels import dispatch
from repro_torch.kernels.phi_fused import pack_patterns
from repro_torch.obs import trace as obs_trace
from repro_torch.snn.lif import LIFConfig, lif_sequence
from repro_torch.utils import cdiv, resolve_device


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    kind: str = "vgg"            # "mlp" | "vgg" | "resnet" | "spikformer"
    num_classes: int = 10
    timesteps: int = 4
    input_size: int = 16
    input_channels: int = 3
    widths: tuple[int, ...] = (32, 64, 128)
    dim: int = 128               # spikformer embed dim
    heads: int = 4
    blocks: int = 2
    attn: str = "ssa"            # "ssa" (softmax-free spiking SA) | "flash" (Phi-dispatched)
    lif: LIFConfig = LIFConfig()
    phi: PhiConfig = PhiConfig()


Params = dict[str, dict[str, torch.Tensor]]
MatmulFn = Callable[[torch.Tensor, torch.Tensor, str], torch.Tensor]
AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, str], torch.Tensor]


def _dense_init(gen: torch.Generator, k_in: int, n_out: int, device: torch.device):
    scale = (2.0 / k_in) ** 0.5
    return {"w": (torch.randn((k_in, n_out), generator=gen) * scale).to(device)}


def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
               device: torch.device):
    scale = (2.0 / (kh * kw * cin)) ** 0.5
    return {"w": (torch.randn((kh, kw, cin, cout), generator=gen) * scale).to(device)}


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1, pad: str = "SAME"
           ) -> torch.Tensor:
    """(..., H, W, C) -> (..., H', W', C·kh·kw) patches (GEMM layout for conv).

    Patch features are ordered channel-major, (C, kh, kw), as the reference's
    ``conv_general_dilated_patches`` orders them. Two ``Tensor.unfold``
    windows over the padded NHWC input give that order as a strided view,
    so the patches are materialised by one copy (``F.unfold`` would launch
    one kernel per image on CUDA).
    """
    lead = x.shape[:-3]
    H, W, C = x.shape[-3:]
    xb = x.reshape(-1, H, W, C)
    if pad == "SAME":
        ph = max((cdiv(H, stride) - 1) * stride + kh - H, 0)
        pw = max((cdiv(W, stride) - 1) * stride + kw - W, 0)
        xb = F.pad(xb, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    elif pad != "VALID":
        raise ValueError(f"pad {pad!r} not in ('SAME', 'VALID')")
    win = xb.unfold(1, kh, stride).unfold(2, kw, stride)          # (N, oh, ow, C, kh, kw)
    return win.reshape(*lead, win.shape[1], win.shape[2], C * kh * kw)


def conv_as_gemm(spikes: torch.Tensor, w: torch.Tensor, stride: int = 1
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Spiking conv as im2col GEMM. Returns (output, gemm_activations).

    The HWIO weight is flattened as (kh, kw, C) against channel-major patch
    features, the pairing the reference uses; this is not a true conv2d.
    """
    kh, kw, cin, cout = w.shape
    cols = im2col(spikes, kh, kw, stride)
    return cols @ w.reshape(kh * kw * cin, cout), cols


# ------------------------------------------------------------------ builds ---
def init(cfg: SNNConfig, generator: torch.Generator,
         device: str | torch.device | None = None) -> Params:
    """Random parameters with the reference's shapes and scales.

    Drawn on the CPU from ``generator`` (so a seed gives the same weights on
    every device), then moved to ``device`` (default ``cuda``).
    """
    dev = resolve_device(device)
    g = generator
    p: Params = {}
    if cfg.kind == "mlp":
        d_in = cfg.input_size * cfg.input_size * cfg.input_channels
        dims = (d_in,) + cfg.widths
        for i in range(len(cfg.widths)):
            p[f"fc{i}"] = _dense_init(g, dims[i], dims[i + 1], dev)
        p["head"] = _dense_init(g, dims[-1], cfg.num_classes, dev)
    elif cfg.kind in ("vgg", "resnet"):
        cin = cfg.input_channels
        for i, cout in enumerate(cfg.widths):
            p[f"conv{i}"] = _conv_init(g, 3, 3, cin, cout, dev)
            if cfg.kind == "resnet" and i > 0:
                p[f"conv{i}b"] = _conv_init(g, 3, 3, cout, cout, dev)
            cin = cout
        p["head"] = _dense_init(g, cfg.widths[-1], cfg.num_classes, dev)
    elif cfg.kind == "spikformer":
        p["embed"] = _dense_init(g, cfg.input_channels * 16, cfg.dim, dev)  # 4x4 patches
        for b in range(cfg.blocks):
            p[f"b{b}_qkv"] = _dense_init(g, cfg.dim, 3 * cfg.dim, dev)
            p[f"b{b}_proj"] = _dense_init(g, cfg.dim, cfg.dim, dev)
            p[f"b{b}_fc1"] = _dense_init(g, cfg.dim, 4 * cfg.dim, dev)
            p[f"b{b}_fc2"] = _dense_init(g, 4 * cfg.dim, cfg.dim, dev)
        p["head"] = _dense_init(g, cfg.dim, cfg.num_classes, dev)
    else:
        raise ValueError(cfg.kind)
    return p


# ----------------------------------------------------------------- forward ---
def _maybe_capture(cap: dict | None, name: str, act: torch.Tensor, k: int) -> None:
    if cap is not None:
        cap[name] = act.reshape(-1, act.shape[-1])[:, : (act.shape[-1] // k) * k]


def _plain_matmul(a: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    return a @ w


def spike_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          patterns: torch.Tensor | None = None, *, site: str = "snn.attn",
                          impl: str | None = None, packed: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Policy-dispatched softmax attention over spikformer head tensors.

    q/k/v: (T, B, H, S, Dh) spike tensors (spikformer head layout). Folds
    timesteps into the batch axis (each timestep's attention is independent)
    and routes through ``kernels.dispatch``: with a calibrated ``patterns``
    bank the site resolves ``phi_flash`` (L1 pattern gather + L2 residual
    score blocks), without one it keeps dense flash. ``impl`` forces an
    ``ATTN_IMPLS`` arm (the bitwise A/B hook ``phi_apply`` exposes as
    ``attn_impl``); both arms share the decision's (block_q, block_kv).
    ``packed`` is the bank as the kernel reads it.
    """
    T, B, H, S, Dh = q.shape

    def fold(z):
        return z.reshape(T * B, H, S, Dh).movedim(1, 2).contiguous()  # (TB, S, H, Dh)

    out = dispatch.get_policy().attention(
        fold(q), fold(k), fold(v), patterns, site=site, causal=False, spike_qk=True,
        override=impl, packed=packed)
    return out.movedim(2, 1).reshape(T, B, H, S, Dh)


def _avg_pool2(h: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 VALID window sum / 4 over (T, B, H, W, C)."""
    H2, W2 = h.shape[2] // 2 * 2, h.shape[3] // 2 * 2
    h = h[:, :, :H2, :W2]
    s = h[:, :, 0::2, 0::2] + h[:, :, 0::2, 1::2] + h[:, :, 1::2, 0::2] + h[:, :, 1::2, 1::2]
    return s / 4.0


def apply(params: Params, cfg: SNNConfig, x: torch.Tensor, *,
          capture: dict | None = None, matmul: MatmulFn = _plain_matmul,
          attention: AttnFn | None = None) -> torch.Tensor:
    """Forward pass. x: (B,H,W,C) images or (B,T,H,W,C) event frames.

    Returns logits (B, classes). ``matmul`` is the injection point for Phi:
    it receives (spike_activations, weight, layer_name) for every spiking
    GEMM. With ``attn="flash"``, ``attention`` receives (q, k, v, site) for
    every spikformer attention site, in the (T, B, H, S, Dh) head layout;
    None routes the site through the execution policy without a bank
    (dense flash).
    """
    T = cfg.timesteps
    if x.ndim == 5:  # event stream: (B, T, H, W, C) — use frames as timesteps
        xs = x.movedim(1, 0)
    else:  # direct coding: repeat analog input T times
        xs = x[None].expand((T,) + tuple(x.shape))
    lif = cfg.lif

    def spiking_linear(h_seq, w, name):
        s = lif_sequence(h_seq, lif)
        _maybe_capture(capture, name, s, cfg.phi.k)
        return matmul(s, w, name)

    if cfg.kind == "mlp":
        h = xs.reshape(T, -1, cfg.input_size * cfg.input_size * cfg.input_channels)
        h = h @ params["fc0"]["w"]  # first layer sees analog input (encoder)
        i = 1
        while f"fc{i}" in params:
            h = spiking_linear(h, params[f"fc{i}"]["w"], f"fc{i}")
            i += 1
        h = spiking_linear(h, params["head"]["w"], "head")
        return h.mean(0)

    if cfg.kind in ("vgg", "resnet"):
        h = xs  # (T, B, H, W, C)
        for i in range(len(cfg.widths)):
            w = params[f"conv{i}"]["w"]
            kh, kw, cin, cout = w.shape
            if i == 0:  # encoder conv on analog input
                h = im2col(h, kh, kw, 1) @ w.reshape(-1, cout)
            else:
                s = lif_sequence(h, lif)
                cols = im2col(s, kh, kw, 1)
                _maybe_capture(capture, f"conv{i}", cols, cfg.phi.k)
                h = matmul(cols, w.reshape(-1, cout), f"conv{i}")
                if cfg.kind == "resnet" and f"conv{i}b" in params:
                    s2 = lif_sequence(h, lif)
                    cols2 = im2col(s2, kh, kw, 1)
                    _maybe_capture(capture, f"conv{i}b", cols2, cfg.phi.k)
                    h = h + matmul(cols2, params[f"conv{i}b"]["w"].reshape(-1, cout),
                                   f"conv{i}b")
            h = _avg_pool2(h)
        # Global *sum* pooling (spike-count readout): mean pooling would leave
        # the classifier LIF sub-threshold at init.
        h = h.sum(dim=(2, 3))  # (T, B, feat)
        h = spiking_linear(h, params["head"]["w"], "head")
        return h.mean(0)

    if cfg.kind == "spikformer":
        B = x.shape[0]
        hw = cfg.input_size // 4
        h = xs.reshape(T, B, hw, 4, hw, 4, cfg.input_channels)
        h = h.permute(0, 1, 2, 4, 3, 5, 6).reshape(T, B, hw * hw, -1)
        h = h @ params["embed"]["w"]  # (T, B, S, D)
        D, H = cfg.dim, cfg.heads

        def heads(z):
            return z.reshape(T, B, -1, H, D // H).permute(0, 1, 3, 2, 4)

        for b in range(cfg.blocks):
            s = lif_sequence(h, lif)
            _maybe_capture(capture, f"b{b}_qkv", s, cfg.phi.k)
            qkv = matmul(s, params[f"b{b}_qkv"]["w"], f"b{b}_qkv")
            q, k_, v = qkv.split(D, dim=-1)
            q, k_, v = (lif_sequence(heads(q), lif), lif_sequence(heads(k_), lif),
                        lif_sequence(heads(v), lif))
            if cfg.attn == "flash":
                # Softmax attention over binary spike Q/K, the Phi-sparse hot
                # path. K spike rows are captured for pattern calibration
                # (the site has no weight; the bank decomposes the scores).
                if D // H >= cfg.phi.k:
                    _maybe_capture(capture, f"b{b}_attn", k_, cfg.phi.k)
                if attention is not None:
                    attn = attention(q, k_, v, f"b{b}_attn")
                else:
                    attn = spike_flash_attention(q, k_, v, site=f"snn.b{b}_attn")
            else:
                attn = (q @ k_.transpose(-1, -2)) @ v * 0.125  # spiking SA: no softmax
            attn = attn.permute(0, 1, 3, 2, 4).reshape(T, B, -1, D)
            sa = lif_sequence(attn, lif)
            _maybe_capture(capture, f"b{b}_proj", sa, cfg.phi.k)
            h = h + matmul(sa, params[f"b{b}_proj"]["w"], f"b{b}_proj")
            s1 = lif_sequence(h, lif)
            _maybe_capture(capture, f"b{b}_fc1", s1, cfg.phi.k)
            m = matmul(s1, params[f"b{b}_fc1"]["w"], f"b{b}_fc1")
            s2 = lif_sequence(m, lif)
            _maybe_capture(capture, f"b{b}_fc2", s2, cfg.phi.k)
            h = h + matmul(s2, params[f"b{b}_fc2"]["w"], f"b{b}_fc2")
        h = h.mean(2)  # (T, B, D)
        s = lif_sequence(h, lif)
        _maybe_capture(capture, "head", s, cfg.phi.k)
        return matmul(s, params["head"]["w"], "head").mean(0)

    raise ValueError(cfg.kind)


# -------------------------------------------------------------- Phi engine ---
@dataclasses.dataclass
class PhiState:
    """Calibrated Phi state: per-layer patterns, PWPs and usage histograms.

    patterns: layer -> (T, q, k) uint8; pwp: layer -> (T, q+1, N), for every
    layer but the attention sites (``b{i}_attn``: their score-block "weight"
    is the q-block, so the pattern×Q products are built per block at run
    time); usage:
    layer -> (T, q+1) pattern-reference counts of the calibration batch.
    Made at construction for every layer not given: packed: layer -> (T, q)
    int64, the patterns as the CUDA kernels read them; p_active: layer ->
    the prefetching kernel's gather size where the layer's usage shows skew
    (``active_pattern_sets``), else None. Both are constant after
    calibration, so no call recomputes them.
    """

    patterns: dict[str, torch.Tensor]
    pwp: dict[str, torch.Tensor]
    usage: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    packed: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    p_active: dict[str, int | None] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        for name, pats in self.patterns.items():
            if name not in self.packed:
                self.packed[name] = pack_patterns(pats)
        for name, u in self.usage.items():
            if name not in self.p_active:
                active, _ = active_pattern_sets(u)
                self.p_active[name] = None if active is None else int(active.shape[-1])


def _layer_weight(params: Params, name: str) -> torch.Tensor:
    w = params[name]["w"]
    return w.reshape(-1, w.shape[-1]) if w.ndim == 4 else w


def calibrate_model(params: Params, cfg: SNNConfig, calib_x: torch.Tensor
                    ) -> tuple[PhiState, dict[str, torch.Tensor]]:
    """Run the Phi calibration stage on a calibration batch.

    Returns (PhiState, captured spike activations in GEMM layout). The
    patterns, PWPs and activations stay on ``calib_x``'s device. Attention
    sites (``*_attn``) get patterns and usage but no PWP.
    """
    cap: dict[str, torch.Tensor] = {}
    with torch.no_grad():
        apply(params, cfg, calib_x, capture=cap)
        patterns, pwps, usage = {}, {}, {}
        for name, act in cap.items():
            pats = calibrate(act, cfg.phi, device=calib_x.device)
            K = pats.shape[0] * cfg.phi.k
            patterns[name] = pats
            usage[name] = pattern_usage(act[:, :K], pats)
            if not name.endswith("_attn"):
                pwps[name] = pattern_weight_products(pats, _layer_weight(params, name)[:K])
    return PhiState(patterns, pwps, usage), cap


def capture_phi_traces(params: Params, cfg: SNNConfig, phi: PhiState, x: torch.Tensor
                       ) -> list:
    """Capture per-layer simulator traces from a real forward pass.

    Runs ``apply`` with activation capture on ``x``'s device (on the card,
    the LIF kernel) and converts every calibrated layer's binary GEMM
    activations into a ``repro_torch.sim.LayerTrace`` against the same
    pattern bank the Phi execution paths use; on the card the matcher
    kernel assigns them (``sim.trace.trace_from_acts``). The captured GEMM
    rows already cover timesteps × batch, so ``reps`` stays 1. Attention
    sites are skipped, as in the reference: they have no weight matrix, and
    ``perfmodel.phi_attention_traffic`` covers them.
    """
    from repro_torch.sim.trace import trace_from_acts

    cap: dict[str, torch.Tensor] = {}
    with torch.no_grad():
        apply(params, cfg, x, capture=cap)
        return [trace_from_acts(f"snn.{name}", cap[name], pats,
                                _layer_weight(params, name).shape[-1])
                for name, pats in phi.patterns.items()
                if name in cap and not name.endswith("_attn")]


def phi_apply(params: Params, cfg: SNNConfig, phi: PhiState, x: torch.Tensor,
              impl: str | None = None, attn_impl: str | None = None) -> torch.Tensor:
    """Inference with Phi sparse matmuls substituted for every spiking GEMM.

    Every GEMM routes through the execution policy (``kernels.dispatch``) as
    site ``snn.<layer>``, as in the reference: ``impl=None`` lets it resolve
    the lowering per call (the prefetching kernel where the layer's
    calibration usage is skewed, the streaming kernel where the K loop is
    long, the first fused kernel elsewhere); ``impl`` forces a name of
    ``IMPLS`` as a per-call override and ``cfg.phi.impl`` as the config
    override (``"pallas"``: the matcher, L1-gather and L2-spmm kernels),
    each demoted where it cannot run. The layer's usage, gather size
    (``PhiState.p_active``) and packed bank go along, so no call recomputes
    them. When ``cfg.attn == "flash"`` the spikformer attention sites route
    through the attention half of the policy with the site's calibrated
    bank; ``attn_impl`` forces an ``ATTN_IMPLS`` arm (``"flash"`` is the
    dense A/B arm, bitwise equal to the resolved ``phi_flash`` for binary
    Q/K). Runs without autograd: the kernels have no backward.
    """
    def phi_mm(a, w, name):
        if name not in phi.patterns:
            return a @ w
        pats = phi.patterns[name]
        K = pats.shape[0] * cfg.phi.k
        # Calibration covers the largest multiple of phi.k that fits the
        # GEMM's K; anything else means the PhiState belongs to another model.
        usable_K = (a.shape[-1] // cfg.phi.k) * cfg.phi.k
        if K != usable_K:
            raise ValueError(
                f"phi_apply: layer {name!r} was calibrated for K={K} but the forward "
                f"pass produces activations with {a.shape[-1]} features (usable "
                f"K={usable_K} at phi.k={cfg.phi.k}); re-run calibrate_model with "
                "the SNNConfig used for apply")
        a_k = a if K == a.shape[-1] else a[..., :K]
        out = dispatch.phi_matmul(
            a_k, w[:K], pats, phi.pwp[name], site=f"snn.{name}", override=impl,
            config_override=cfg.phi.impl, nnz_budget=cfg.phi.nnz_budget,
            usage=phi.usage.get(name), p_active=phi.p_active.get(name),
            packed=phi.packed[name])
        if K < a.shape[-1]:  # dense ragged tail (K not a multiple of phi.k)
            out = out + a[..., K:] @ w[K:]
        return out.to(w.dtype)

    def phi_attn(qh, kh, vh, name):
        return spike_flash_attention(qh, kh, vh, phi.patterns.get(name), site=f"snn.{name}",
                                     impl=attn_impl, packed=phi.packed.get(name))

    # the host's time to enqueue the batch: it returns before the card is done
    with torch.no_grad(), obs_trace.span("snn.phi_apply", obs_trace.get_tracer(),
                                         rows=x.shape[0]):
        return apply(params, cfg, x, matmul=phi_mm,
                     attention=phi_attn if cfg.attn == "flash" else None)
