"""LM facade: embeddings + decoder stack + head (port of ``repro/models/model.py``).

Entry points (plain functions of (cfg, params, batch); tensors on any
device, and they run where the params lie):
  * ``train_logits``  — full-sequence forward for training / evaluation.
  * ``train_loss``    — masked token cross-entropy (f32).
  * ``prefill``       — forward that also returns decode state (KV caches;
                        SSM states and conv rings for Mamba-2; both for the
                        hybrid) and last-position logits.
  * ``decode_step``   — one-token step against the decode state, which it
                        updates in place (the reference returns new state;
                        the port writes the preallocated one).

Phi spiking mode (``cfg.spiking`` + ``cfg.phi``): every decoder GEMM operand
is rate-coded into ``phi.timesteps`` binary spike trains by a local LIF
neuron (on the card, the LIF sequence kernel over the operand broadcast
along T, bitwise the reference's ``lif_update`` loop); each timestep's
matmul is the Phi decomposition through the ``kernels.dispatch`` execution
policy, which picks the kernel per call. Given identical spikes, Phi mode is
exact against the spiking-dense matmul (:func:`spiking_dense_matmul`, the
oracle of ``tests/test_archs.py``); on dyadic weights bitwise.

Every entry point takes an optional ``matmul`` (the reference's
``_forward`` hook, here also on ``prefill`` and the decode steps), so the
spiking-dense arm can run the same serving path.

Every family of the ten configs runs: the attention families (dense,
sliding-window, chunked-local/global), the patch and frame frontends (stub
embeddings, as in the reference), Mamba-2 (``ssm``), the Zamba2 hybrid and
MoE layers. Single device: ``_phi_sharded_matmul`` keeps only its
single-device branch and MoE only its dense branch; ``moe_impl="ep"`` raises
(both wait for ``ROADMAP.md`` queue 1's multi-device item).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.assign import PhiStats
from repro_torch.core.patterns import PhiConfig
from repro_torch.distributed.sharding import ParamSpec, is_spec, shard
from repro_torch.kernels import dispatch
from repro_torch.models import layers as ll
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.snn.lif import LIFConfig, lif_sequence
from repro_torch.utils import resolve_device


# ------------------------------------------------------------------ specs ---
def lm_specs(cfg: ModelConfig) -> dict:
    dt = cfg.param_dtype
    sp = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "fsdp"), dt, scale=0.02),
        "head": ParamSpec((cfg.d_model, cfg.vocab), ("fsdp", "vocab"), dt),
        "ln_f": ll.norm_spec(cfg),
        "decoder": transformer.decoder_specs(cfg),
    }
    if cfg.phi is not None:
        sp["decoder"] = _inject_phi_specs(cfg, sp["decoder"])
    return sp


_PHI_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3",
                "wz", "wx", "wB", "wC", "wdt")


def _inject_phi_specs(cfg: ModelConfig, tree: Any) -> Any:
    """Add per-weight Phi state (patterns + PWP + usage) next to each spiking GEMM."""
    phi = cfg.phi

    def eligible(v) -> bool:
        if not is_spec(v) or v.shape[-2] % phi.k:
            return False
        # plain 2D GEMM weight, possibly layer-stacked (expert tensors are
        # contracted by einsum, not the injectable mm — excluded by ndim/axes)
        return len(v.shape) == 2 or (len(v.shape) == 3 and v.axes[0] == "layers")

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = dict(node)
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in _PHI_WEIGHTS and eligible(v):
                K, N = v.shape[-2], v.shape[-1]
                T = K // phi.k
                lead = v.shape[:-2]
                lead_ax = v.axes[:-2]
                entry = {
                    "patterns": ParamSpec(
                        lead + (T, phi.q, phi.k), lead_ax + ("pattern", None, None),
                        torch.int8, init="zeros"),
                    "pwp": ParamSpec(
                        lead + (T, phi.q + 1, N), lead_ax + ("pwp_tiles", None, v.axes[-1]),
                        torch.int8 if phi.pwp_int8 else cfg.param_dtype, init="zeros"),
                    # Calibration pattern-usage histogram; the execution
                    # policy reads it from its host-side registry.
                    "usage": ParamSpec(
                        lead + (T, phi.q + 1), lead_ax + (None, None),
                        torch.int32, init="zeros"),
                }
                if phi.pwp_int8:
                    entry["pwp_scale"] = ParamSpec(
                        lead + (T, phi.q + 1), lead_ax + ("pwp_tiles", None),
                        torch.float32, init="zeros")
                out["phi_" + k] = entry
        return out

    return walk(tree)


def split_phi_state(tree: Any) -> tuple[Any, dict]:
    """Split a params(-spec) tree into (trainable, phi_state).

    ``phi_*`` subtrees (patterns / PWPs / usage) are calibration-derived
    state, not trainable parameters; the optimizer must only see the
    trainable half.
    """
    if not isinstance(tree, dict):
        return tree, {}
    train: dict = {}
    frozen: dict = {}
    for k, v in tree.items():
        if k.startswith("phi_"):
            frozen[k] = v
        elif isinstance(v, dict):
            t, f = split_phi_state(v)
            train[k] = t
            if f:
                frozen[k] = f
        else:
            train[k] = v
    return train, frozen


def merge_phi_state(train: Any, frozen: dict) -> Any:
    """Inverse of ``split_phi_state``: graft the phi state back in."""
    if not frozen:
        return train
    out = dict(train)
    for k, v in frozen.items():
        if k in out and isinstance(out.get(k), dict) and not k.startswith("phi_"):
            out[k] = merge_phi_state(out[k], v)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------- spiking matmul ---
def rate_code(x: torch.Tensor, timesteps: int, lif: LIFConfig) -> torch.Tensor:
    """T binary spike trains (T, ..., K) f32 of a constant operand ``x``: LIF
    from v = 0 over ``x`` repeated T times (the reference's ``scan`` of
    ``lif_update``). Without autograd the LIF sequence kernel runs it on the
    card (its plain version on the CPU); both are bitwise that loop."""
    xf = x.to(torch.float32)
    return lif_sequence(xf.unsqueeze(0).expand(timesteps, *xf.shape), lif)


def _phi_sharded_matmul(cfg, spikes, w, patterns, pwp, name, budget, pwp_scale=None):
    """Phi matmul of one call site. The single-device branch of the
    reference's: the execution policy resolves the lowering (the model layer
    never names one, except through ``cfg.phi.impl``)."""
    override = cfg.phi.impl if cfg.phi is not None else None
    return dispatch.phi_matmul(spikes, w, patterns, pwp, site=f"lm.{name}",
                               config_override=override, nnz_budget=budget,
                               gather_dtype=cfg.compute_dtype, pwp_scale=pwp_scale)


def make_matmul(cfg: ModelConfig):
    """Returns the GEMM implementation for this config (dense / spiking-Phi)."""
    if not cfg.spiking:
        return None  # default dense mm

    phi = cfg.phi or PhiConfig()
    lif = LIFConfig(decay=0.5, threshold=1.0)
    spike_impl = getattr(cfg, "spike_impl", "phi")

    def mm(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
        w = p[name]
        phi_p = p.get("phi_" + name)
        spikes = rate_code(x, phi.timesteps, lif)                  # (T, ..., K)
        if phi_p is None:
            out = spikes.to(cfg.compute_dtype) @ w.to(cfg.compute_dtype)
        elif spike_impl != "phi":
            # Oracle comparison mode (cfg.spike_impl names a lowering): the
            # one context where the model layer pins the impl.
            out = dispatch.phi_matmul(spikes, w.to(torch.float32), phi_p["patterns"],
                                      phi_p["pwp"].to(torch.float32),
                                      site=f"lm.{name}.oracle", override=spike_impl)
        else:
            pwp_v = phi_p["pwp"]
            if pwp_v.dtype != torch.int8:
                pwp_v = pwp_v.to(torch.float32)
            out = _phi_sharded_matmul(
                cfg, spikes, w.to(torch.float32), phi_p["patterns"], pwp_v, name,
                phi.nnz_budget, pwp_scale=phi_p.get("pwp_scale"))
        # rate decoding: average over timesteps, rescale by threshold
        return (out.mean(0) * (2.0 * lif.threshold)).to(x.dtype)

    return mm


def spiking_dense_matmul(cfg: ModelConfig):
    """The spiking-dense oracle (``tests/test_archs.py``'s ``dense_mm``):
    the same rate coding as :func:`make_matmul`, then a float32 matmul of
    the spikes with the weight. On dyadic weights every partial sum is exact,
    so Phi mode equals it bitwise."""
    phi = cfg.phi or PhiConfig()
    lif = LIFConfig()

    def mm(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
        spikes = rate_code(x, phi.timesteps, lif)
        out = spikes @ p[name].to(torch.float32)
        return (out.mean(0) * 2.0).to(x.dtype)

    return mm


def _capture_phi_spikes(cfg: ModelConfig, params: dict,
                        sample_batch: dict) -> dict[str, list]:
    """Shared spike-capture pass of the phi-LM paths.

    Runs the forward with dense math and an instrumented matmul that
    rate-codes every Phi-eligible GEMM operand and keeps the spike trains
    (uint8, on the params' device). Returns {call-site key: [spikes, one per
    call]} with keys ``f"{weight_name}#{occurrence}"``.
    """
    return _capture(cfg, params, sample_batch)[0]


def _capture(cfg: ModelConfig, params: dict, sample_batch: dict):
    """``_capture_phi_spikes`` and {weight address: its site key}.

    The reference keys a call by its place in the traced scan bodies: the
    n-th distinct site of a weight name in forward order is ``name#n``, and
    its list holds one spike array per scan iteration. The port loops, so a
    site fires once per layer of its stack (a shared 2-D weight once per
    call), and it reads a layer's view of its stacked weight: each view's
    address names its site, and a site takes its key the first time the
    forward reaches it. Keys therefore follow the forward, whatever order the
    params dicts hold their keys in, as the walks that consume them need.
    """
    view_site: dict[int, int] = {}      # address of each view -> its weight's

    def views(node, name):
        w = node[name]
        for v in (w,) if w.ndim == 2 else w.unbind(0):
            view_site[v.data_ptr()] = w.data_ptr()

    _phi_sites(params, views)
    site_key: dict[int, str] = {}
    count: dict[str, int] = {}
    captured: dict[str, list] = {}
    lif = LIFConfig()
    phi = cfg.phi

    def capture_mm(x, p, name):
        w = p[name]
        if "phi_" + name in p:
            site = view_site[w.data_ptr()]
            if site not in site_key:
                site_key[site] = f"{name}#{count.get(name, 0)}"
                count[name] = count.get(name, 0) + 1
            spikes = rate_code(x, phi.timesteps, lif)
            captured.setdefault(site_key[site], []).append(spikes.to(torch.uint8))
        return x @ w.to(x.dtype)

    with torch.no_grad():
        _forward(cfg.with_(spiking=False), params, sample_batch, matmul=capture_mm)
    return captured, site_key


def _phi_sites(node: dict, visit) -> dict:
    """Walk a params tree (dict order) and call ``visit(node, name)`` at each
    weight with a ``phi_`` sibling; returns the tree with each site's ``phi_``
    entry replaced by what ``visit`` returns (or kept where it returns None)."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        out = dict(node)
        for k, v in list(node.items()):
            if isinstance(v, dict) and not k.startswith("phi_"):
                out[k] = walk(v)
            if "phi_" + k in node:
                new = visit(node, k)
                if new is not None:
                    out["phi_" + k] = new
        return out

    return walk(node)


def _spike_rows(captured: dict, key: str, K: int) -> torch.Tensor:
    return torch.cat([s.reshape(-1, K) for s in captured[key]])


def _usage_and_stats(spk: torch.Tensor, pats: torch.Tensor,
                     rows: int = 8192) -> tuple[np.ndarray, PhiStats]:
    """``pattern_usage`` and ``phi_stats`` of binary rows ``spk`` (M, K)
    against ``pats`` (T, q, k), from one assignment in chunks of ``rows``
    (the matcher kernel on the card, its plain version, ``assign_patterns``,
    on the CPU): integer counts, the same as the two functions give, without
    their (M, T, q) score tensor."""
    from repro_torch.kernels.matcher import matcher_cuda

    T, q, k = pats.shape
    M, K = spk.shape
    dev = spk.device
    offs = torch.arange(T, device=dev) * (q + 1)
    pop_p = (pats != 0).sum(-1)                                          # (T, q) int64
    hist = torch.zeros(T * (q + 1), dtype=torch.int64, device=dev)
    bits = l1 = pos = neg = assigned = 0
    for r0 in range(0, M, rows):
        a = spk[r0:r0 + rows].to(torch.float32).contiguous()
        idx, res = matcher_cuda(a, pats)
        hist += torch.bincount((idx.long() + offs).reshape(-1), minlength=T * (q + 1))
        used = idx < q
        l1 += pop_p[torch.arange(T, device=dev)[None, :],
                    torch.where(used, idx, 0).long()][used].sum()
        bits += spk[r0:r0 + rows].sum(dtype=torch.int64)
        pos += (res == 1).sum()
        neg += (res == -1).sum()
        assigned += used.sum()
    size = float(M * K)
    stats = PhiStats(bit_density=float(bits) / size, l1_density=float(l1) / size,
                     l2_pos_density=float(pos) / size, l2_neg_density=float(neg) / size,
                     idx_density=float(assigned) / float(M * T), rows=M, cols=K)
    return hist.reshape(T, q + 1).cpu().numpy(), stats


def capture_lm_phi_traces(cfg: ModelConfig, params: dict, sample_batch: dict) -> list:
    """Capture simulator traces from a *calibrated* phi-LM's real spikes.

    Re-runs the spike-capture pass and pairs each call site's pooled spike
    rows with the ``phi_*`` pattern bank already in the params tree,
    yielding one ``repro_torch.sim.LayerTrace`` per Phi GEMM site
    (stacked-layer sites use the pooled patterns, as calibration did). On
    the card the matcher kernel assigns every trace.
    """
    from repro_torch.sim.trace import trace_from_acts

    captured, site_key = _capture(cfg, params, sample_batch)
    traces = []

    def visit(node, name):
        key = site_key.get(node[name].data_ptr())
        if key is not None:
            pats = node["phi_" + name]["patterns"]
            if pats.ndim == 4:      # stacked layers: pooled patterns
                pats = pats[0]
            w = node[name]
            spk = _spike_rows(captured, key, w.shape[-2])
            traces.append(trace_from_acts(f"lm.{key}", spk, pats.to(torch.uint8),
                                          w.shape[-1]))

    _phi_sites(params, visit)
    return traces


def calibrate_lm_phi(cfg: ModelConfig, params: dict, sample_batch: dict,
                     init_idx: dict | None = None) -> tuple[dict, dict]:
    """Fill the zero-initialised Phi state from real spike statistics.

    The capture pass runs the forward with an instrumented matmul that keeps
    each GEMM's spike trains. Patterns are calibrated on each call site's
    pooled spikes (shared across a stack's layers, and across the calls of a
    shared weight) and PWPs are per layer, against each layer's weight. Call
    sites are keyed by (weight name, occurrence in the forward), as the
    reference's capture keys them.

    The banks of ``params`` are written in place where their shape and dtype
    fit (the full configs' banks are tens of GB: a second copy would not fit
    beside them), layer by layer; the returned tree shares every tensor with
    ``params``. ``init_idx`` (key -> per-partition k-means initial rows, see
    ``core.patterns.calibrate``) lets parity tests start from the
    reference's rows. Returns (params, {key: PhiStats}).
    """
    from repro_torch.core.patterns import calibrate as _calib, pattern_weight_products

    stats: dict[str, PhiStats] = {}
    phi = cfg.phi
    captured, site_key = _capture(cfg, params, sample_batch)

    def into(old: torch.Tensor | None, new: torch.Tensor) -> torch.Tensor:
        if old is not None and old.shape == new.shape and old.dtype == new.dtype:
            return old.copy_(new)
        return new.clone()

    def visit(node, name):
        key = site_key.get(node[name].data_ptr())
        if key is None:
            return None
        w = node[name]
        old = node["phi_" + name]
        dev = w.device
        spk = _spike_rows(captured, key, w.shape[-2])
        pats = _calib(spk, phi, device=dev,
                      init_idx=None if init_idx is None else init_idx.get(key))
        usage, st = _usage_and_stats(spk, pats)
        dispatch.get_policy().register_usage(f"lm.{name}", usage)
        stats[key] = st
        w32 = w.to(torch.float32)
        if w.ndim == 2:
            pwp = into(old.get("pwp"), pattern_weight_products(pats, w32).to(cfg.param_dtype))
            pats_t, usage_np = pats, usage
        else:  # stacked layers: pooled patterns, per-layer PWPs
            L = w.shape[0]
            bank = old.get("pwp")
            if bank is None or bank.shape != (L,) + (pats.shape[0], phi.q + 1, w.shape[-1]) \
                    or bank.dtype != cfg.param_dtype:
                bank = torch.empty((L, pats.shape[0], phi.q + 1, w.shape[-1]),
                                   dtype=cfg.param_dtype, device=dev)
            for li in range(L):
                bank[li].copy_(pattern_weight_products(pats, w32[li]))
            pwp = bank
            pats_t = pats.expand((L,) + pats.shape)
            usage_np = np.broadcast_to(usage, (L,) + usage.shape)
        usage_t = torch.as_tensor(np.clip(usage_np, 0, np.iinfo(np.int32).max)
                                  .astype(np.int32), device=dev)
        return {"patterns": into(old.get("patterns"), pats_t.to(torch.int8)),
                "pwp": pwp,
                "usage": into(old.get("usage"), usage_t)}

    new_params = _phi_sites(params, visit)
    return new_params, stats


# ---------------------------------------------------------------- forward ---
def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Token + stub-frontend embedding -> (B, S_total, D) in compute dtype."""
    parts = []
    if cfg.frontend == "patches":
        parts.append(batch["patch_embeds"].to(cfg.compute_dtype))
    if cfg.frontend == "frames":
        x = batch["frame_embeds"].to(cfg.compute_dtype)
        return shard(x, "batch", "seq", "act_embed")
    tok = params["embed"][batch["tokens"].long()].to(cfg.compute_dtype)
    parts.append(tok)
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return shard(x, "batch", "seq", "act_embed")


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = ll.apply_norm(cfg, params["ln_f"], x)
    logits = x.to(cfg.compute_dtype) @ params["head"].to(cfg.compute_dtype)
    return shard(logits.to(torch.float32), "batch", "seq", "act_vocab")


def _forward(cfg: ModelConfig, params: dict, batch: dict, matmul=None,
             want_cache: bool = False):
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    mm = matmul if matmul is not None else make_matmul(cfg)
    return transformer.stack_prefill(cfg, params["decoder"], x, positions,
                                     matmul=mm, want_cache=want_cache)


def train_logits(cfg: ModelConfig, params: dict, batch: dict, matmul=None) -> torch.Tensor:
    x, _ = _forward(cfg, params, batch, matmul)
    return _logits(cfg, params, x)


def train_loss(cfg: ModelConfig, params: dict, batch: dict, matmul=None) -> torch.Tensor:
    """Masked next-token cross-entropy. labels: (B, S_total) int, -1 = pad."""
    logits = train_logits(cfg, params, batch, matmul)
    labels = batch["labels"].long()
    logp = F.log_softmax(logits, dim=-1)
    take = torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return -(take * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def prefill(cfg: ModelConfig, params: dict, batch: dict, matmul=None):
    """Returns (last-position logits (B, V), decode state)."""
    x, caches = _forward(cfg, params, batch, matmul, want_cache=True)
    logits = _logits(cfg, params, x[:, -1:])
    return logits[:, 0], caches


def prefill_padded(cfg: ModelConfig, params: dict, batch: dict,
                   last_pos: torch.Tensor, matmul=None):
    """Prefill a right-padded prompt batch, reading logits at the TRUE last
    token ``last_pos`` ((B,) int, 0-based) instead of the padded end.

    Right-padding is exact only under causal *full* attention: rows at
    positions < true length never attend to the pad tail, and decode later
    masks (then progressively overwrites) the junk cache slots past
    ``last_pos``. Ring/windowed caches and recurrent state fold the pad
    tokens into state — callers must gate on family/attn_type (the serve
    engine's prompt bucketing does).
    """
    x, caches = _forward(cfg, params, batch, matmul, want_cache=True)
    idx = last_pos.to(device=x.device, dtype=torch.long)[:, None, None]
    sel = torch.gather(x, 1, idx.expand(x.shape[0], 1, x.shape[2]))
    logits = _logits(cfg, params, sel)
    return logits[:, 0], caches


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor, pos: torch.Tensor,
                caches, embeds: torch.Tensor | None = None, matmul=None):
    """token (B,) int (or embeds (B, D) for frame frontends); pos (B,) int.
    The caches are written in place and returned."""
    if embeds is not None:
        x = embeds[:, None].to(cfg.compute_dtype)
    else:
        x = params["embed"][token.long()][:, None].to(cfg.compute_dtype)
    x = shard(x, "batch", None, "act_embed")
    mm = matmul if matmul is not None else make_matmul(cfg)
    x, new_caches = transformer.stack_decode(cfg, params["decoder"], x, pos, caches,
                                             matmul=mm)
    logits = _logits(cfg, params, x)
    return logits[:, 0], new_caches


def decode_step_paged(cfg: ModelConfig, params: dict, token: torch.Tensor,
                      pos: torch.Tensor, pools: Any, page_table: torch.Tensor,
                      matmul=None):
    """One-token decode against a paged KV cache.

    Identical to ``decode_step`` except the attention caches are the shared
    page pools from ``init_paged_state`` plus the engine's page table
    ((B, logical_pages) int32, -1 = unmapped) — see
    ``serve/page_manager.py`` for the layout and the bitwise-exactness
    contract. Full-attention families only. The pools are written in place.
    """
    x = params["embed"][token.long()][:, None].to(cfg.compute_dtype)
    x = shard(x, "batch", None, "act_embed")
    mm = matmul if matmul is not None else make_matmul(cfg)
    x, new_pools = transformer.stack_decode_paged(
        cfg, params["decoder"], x, pos, pools, page_table, matmul=mm)
    logits = _logits(cfg, params, x)
    return logits[:, 0], new_pools


# ----------------------------------------------------------- input specs ---
@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor that is not allocated (the port's
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def input_batch_specs(cfg: ModelConfig, batch: int, seq: int, with_labels: bool,
                      dtype=torch.int32) -> dict:
    """Stand-ins for a model input batch (dry-run pattern)."""
    sp: dict = {}
    if cfg.frontend == "patches":
        P = cfg.frontend_positions
        sp["tokens"] = TensorSpec((batch, seq - P), dtype)
        sp["patch_embeds"] = TensorSpec((batch, P, cfg.d_model), cfg.compute_dtype)
    elif cfg.frontend == "frames":
        sp["frame_embeds"] = TensorSpec((batch, seq, cfg.d_model), cfg.compute_dtype)
    else:
        sp["tokens"] = TensorSpec((batch, seq), dtype)
    if with_labels:
        sp["labels"] = TensorSpec((batch, seq), dtype)
    return sp


def dummy_batch(cfg: ModelConfig, batch: int, seq: int, with_labels: bool,
                gen: torch.Generator | None = None,
                device: str | torch.device | None = None) -> dict:
    """A random input batch from ``gen`` (default: seed 0), on ``device``
    (``cuda`` unless the caller names another): tokens uniform in the vocab,
    labels in {0, 1}, embeddings normal × 0.5, as the reference draws them
    (from its own ``jax.random`` stream, which the port cannot replay)."""
    device = resolve_device(device)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    out = {}
    for k, s in input_batch_specs(cfg, batch, seq, with_labels).items():
        if not s.dtype.is_floating_point:
            hi = min(2 if k == "labels" else cfg.vocab, cfg.vocab)
            x = torch.randint(0, hi, s.shape, generator=gen, device=gen.device)
            out[k] = x.to(device=device, dtype=s.dtype)
        else:
            x = torch.randn(s.shape, generator=gen, device=gen.device)
            out[k] = (x.to(s.dtype) * 0.5).to(device)
    return out


def extend_caches(cfg: ModelConfig, caches: Any, new_len: int) -> Any:
    """Grow linear KV caches to ``new_len`` slots (ring caches stay fixed).

    Prefill returns caches sized to the prompt; the serving engine extends
    them to the generation budget before decoding. SSM states and conv rings
    have no sequence axis: they pass through; the hybrid pads only its
    shared block's ``"kv"``.
    """
    def pad_kv(kv, win):
        k, v = kv
        cur = k.shape[-3]
        target = min(new_len, win) if win is not None else new_len
        if target <= cur:
            return (k, v)
        pad = [0, 0, 0, 0, 0, target - cur]
        return (F.pad(k, pad), F.pad(v, pad))

    if cfg.family == "ssm":
        return caches
    if cfg.family == "hybrid":
        return {**caches, "kv": pad_kv(caches["kv"], None)}
    g = transformer.group_size(cfg)
    return tuple(
        pad_kv(caches[i], transformer._cache_window(cfg, cfg.is_global_layer(i)))
        for i in range(g)
    )


# ------------------------------------------------------------ cache specs ---
def _ssm_state_specs(cfg: ModelConfig, lead: tuple, batch: int) -> tuple:
    """(ssm, {"x", "B", "C"}) specs of Mamba-2 layers stacked on ``lead``."""
    from repro_torch.models import mamba2

    sp = mamba2.mamba_state_specs(cfg, batch, 1)

    def mk(s):
        return TensorSpec(lead + s.shape[1:], s.dtype)

    return mk(sp["ssm"]), {k: mk(sp["conv_" + k]) for k in ("x", "B", "C")}


def decode_state_specs(cfg: ModelConfig, batch: int, context: int) -> Any:
    """Specs of what ``prefill`` returns for a (batch, context) prompt.

    Attention families: per group position, (k, v) of (n_groups, batch,
    cache_len, kv_heads_padded, hd) in the compute dtype, cache_len =
    min(context, window) for ring caches. ``ssm``: (ssm (L, batch, H, P, N)
    float32, {"x", "B", "C"} conv rings (L, batch, kc - 1, C) in the compute
    dtype). ``hybrid``: {"mamba": the main layers' state on (n_sites, g),
    "kv": the shared block's (k, v) on n_sites, "tail": the tail's, or
    None}. The reference derives this with ``jax.eval_shape`` on prefill;
    the port derives it from the config (held against the reference's in a
    test)."""
    g = transformer.group_size(cfg)
    if cfg.family == "ssm":
        return _ssm_state_specs(cfg, (cfg.n_layers,), batch)
    kv_shape = (batch, context, cfg.kv_heads_padded, cfg.hd)
    if cfg.family == "hybrid":
        n_sites = cfg.n_layers // g
        tail = cfg.n_layers - n_sites * g
        kv = TensorSpec((n_sites,) + kv_shape, cfg.compute_dtype)
        return {"mamba": _ssm_state_specs(cfg, (n_sites, g), batch), "kv": (kv, kv),
                "tail": _ssm_state_specs(cfg, (tail,), batch) if tail else None}
    out = []
    for i in range(g):
        win = transformer._cache_window(cfg, cfg.is_global_layer(i))
        length = min(context, win) if win is not None else context
        s = TensorSpec((cfg.n_layers // g, batch, length) + kv_shape[2:], cfg.compute_dtype)
        out.append((s, s))
    return tuple(out)


def map_state(fn, tree: Any) -> Any:
    """``fn`` applied to every leaf of a decode-state tree (tuples, dicts,
    None), keeping its structure; dict keys in sorted order, as
    ``jax.tree`` visits them."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_state(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return tuple(map_state(fn, v) for v in tree)
    return fn(tree)


def state_leaves(tree: Any) -> list:
    """The leaves of a decode-state tree, in its order."""
    out: list = []
    map_state(out.append, tree)
    return out


def state_batch_axes(cfg: ModelConfig, tree: Any) -> Any:
    """The batch axis of every leaf of a decode-state tree: 2 for the
    hybrid's main Mamba-2 states (n_sites, g, B, ...), 1 everywhere else."""
    if cfg.family == "hybrid":
        return {k: map_state(lambda _: 2 if k == "mamba" else 1, v) for k, v in tree.items()}
    return map_state(lambda _: 1, tree)


def _zeros(specs: Any, device) -> Any:
    return map_state(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), specs)


def init_decode_state(cfg: ModelConfig, batch: int, context: int,
                      device: str | torch.device | None = None) -> Any:
    """Concrete zero-initialised decode state (serving engine cold start)."""
    return _zeros(decode_state_specs(cfg, batch, context), resolve_device(device))


def paged_state_specs(cfg: ModelConfig, num_pages: int, page_size: int) -> Any:
    """Specs of the shared page pools: every KV leaf's (batch, seq) axes
    become (num_pages + 1, page_size) — one pool shared by all slots, plus
    the reserved scratch page (see ``serve/page_manager.py``)."""
    if cfg.family in ("ssm", "hybrid") or cfg.attn_type != "full":
        raise ValueError(
            f"paged state supports full-attention families only, not "
            f"family={cfg.family!r} attn_type={cfg.attn_type!r}")
    specs = decode_state_specs(cfg, 1, page_size)

    def mk(s):
        return TensorSpec((s.shape[0], num_pages + 1) + s.shape[2:], s.dtype)

    return map_state(mk, specs)


def init_paged_state(cfg: ModelConfig, num_pages: int, page_size: int,
                     device: str | torch.device | None = None) -> Any:
    """Concrete zero-initialised page pools (paged serving cold start)."""
    return _zeros(paged_state_specs(cfg, num_pages, page_size), resolve_device(device))
