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
MoE layers.

On a mesh (``sharding.use_rules(rules, mesh)``), every family serves and
trains from per-rank shards (``param_shardings``; ``sharding.place`` cuts
them): the entry points take the global batch, run this rank's rows (the
``batch`` axis; a batch it does not divide is replicated) on its heads and
its slice of ``d_ff``, and return the logits gathered over both. Collectives
stand where the reference's ``pjit`` and ``shard_map`` put them: the
row-parallel GEMMs (``wo``, ``w2``) sum their partial products over
``model`` in float32, the vocab-parallel embedding lookup is masked and
summed, and the vocab-parallel head's logits are gathered. Each Phi GEMM
runs ``dispatch.phi_matmul`` on the rank's local spikes and shards in a
per-rank body (site ``lm.{name}.spmd``), so the policy re-gates on the
local shape. On dyadic weights every partial sum is exact. The library
contractions (materialised attention, the head) sum in an order that
depends on their shapes, so a rank makes one device's call with zeros in
place of the other ranks' rows, heads and vocab (``layers.one_device_call``,
:func:`_logits`): the mesh's logits equal one device's bitwise. Mamba-2
(``ssm``) and the Zamba2 hybrid serve and train on a mesh too: a rank runs
its block of the SSM heads (``models.mamba2``), the shared block as the
attention families run theirs, and :func:`_layout` tells the Mamba-2 and
shared ``wo`` apart by their local shapes. Paged decode runs on a mesh
from page pools that hold the rank's KV heads and every page
(:func:`init_paged_state`), each rank reading its rows' pages through its
rows of the global page table.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.assign import PhiStats
from repro_torch.core.patterns import PhiConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (
    SERVE_RULES, ParamSpec, axis_names_of, axis_size, current_mesh, current_rules, is_spec,
    local_shape, resolve_spec, shard, specs_to_shardings, use_batch_rows)
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


# Logical (K, N) axes of every Phi-eligible weight, as the reference's table.
_WEIGHT_AXES = {
    "wq": ("fsdp", "heads"), "wk": ("fsdp", "kv_heads"), "wv": ("fsdp", "kv_heads"),
    "wo": ("heads", "fsdp"), "w1": ("fsdp", "mlp"), "w3": ("fsdp", "mlp"),
    "w2": ("mlp", "fsdp"), "wz": ("fsdp", "heads"), "wx": ("fsdp", "heads"),
    "wB": ("fsdp", "state"), "wC": ("fsdp", "state"), "wdt": ("fsdp", "heads"),
}


def _gemm_spec_axes(shape: tuple, logical: tuple, mesh, rules) -> tuple:
    """(k_ax, n_ax) of a GEMM weight of global ``shape`` (..., K, N) whose
    logical (K, N) axes are ``logical``, by the reference's rule: each axis
    resolved alone and replicated where it does not divide its dim; an axis
    that reuses a mesh axis of the batch's, or N one of K's, is dropped (a
    placement uses each mesh axis once; the placements assume a batch the
    ``batch`` axes divide)."""
    def ax(lg, dim):
        p = resolve_spec((lg,), rules, mesh)
        a = p[0] if p else None
        return a if a is not None and dim % axis_size(mesh, a) == 0 else None

    bd = resolve_spec(("batch",), rules, mesh)
    bd = set(axis_names_of(bd[0] if bd else None))
    k_ax, n_ax = ax(logical[0], shape[-2]), ax(logical[1], shape[-1])
    if set(axis_names_of(k_ax)) & bd:
        k_ax = None
    if set(axis_names_of(n_ax)) & (bd | set(axis_names_of(k_ax))):
        n_ax = None
    return k_ax, n_ax


def _weight_axes(name: str, spec: ParamSpec) -> tuple:
    """The logical (K, N) axes of the GEMM weight ``name`` of ``spec``:
    ``_WEIGHT_AXES``', replicated where the spec replicates the dim (``wk``,
    ``wv`` of a config with fewer KV heads than its TP degree store the
    logical heads, whole on every rank; ``transformer._qkv`` then takes the
    rank's block of their padded copies)."""
    return tuple(w if s is not None else None
                 for w, s in zip(_WEIGHT_AXES[name], spec.axes[-2:]))


def _gemm_weights(specs: Any):
    """(node, name, spec) of every GEMM weight named in _WEIGHT_AXES: 2-D or
    stacked on a leading ``layers`` axis."""
    for k, v in specs.items():
        if isinstance(v, dict):
            yield from _gemm_weights(v)
        elif k in _WEIGHT_AXES and _is_gemm_weight(v):
            yield specs, k, v


def _is_gemm_weight(spec: ParamSpec) -> bool:
    return len(spec.shape) == 2 or (len(spec.shape) == 3 and spec.axes[0] == "layers")


def _lead(spec: ParamSpec, mesh, rules) -> tuple:
    return tuple((resolve_spec((a,), rules, mesh) or (None,))[0] for a in spec.axes[:-2])


def _trim(p: tuple) -> tuple:
    p = list(p)
    while p and p[-1] is None:
        p.pop()
    return tuple(p)


def _pwp_tiles_axis(T: int, k_ax, used: tuple, mesh, rules):
    """The placement entry of a PWP bank's K-partition dim (T partitions):
    K's axis ``k_ax`` and, within each of its blocks, the axis the rules name
    ``pwp_tiles`` (``data`` under both rule tables), where that axis is on
    the mesh, not among ``used`` (the bank's other dims') and divides the
    block; else ``k_ax`` alone."""
    t_ax = (resolve_spec(("pwp_tiles",), rules, mesh) or (None,))[0]
    names = axis_names_of(t_ax)
    taken = set(axis_names_of(k_ax)) | {a for u in used for a in axis_names_of(u)}
    if not names or set(names) & taken or (T // axis_size(mesh, k_ax)) % axis_size(mesh, t_ax):
        return k_ax
    both = axis_names_of(k_ax) + names
    return both[0] if len(both) == 1 else both


def param_shardings(cfg: ModelConfig, mesh, rules: dict | None = None) -> dict:
    """The placement of every leaf of ``lm_specs(cfg)`` on ``mesh``: per leaf,
    the mesh axes each dim is split over (``sharding.specs_to_shardings``),
    except that each GEMM weight and its Phi state are placed as the GEMM's
    per-rank body reads them (the reference's ``shard_map`` in-specs): the
    weight by (k_ax, n_ax), its patterns' K-partitions with K, its usage
    histogram whole. Its PWP bank (and ``pwp_scale``) is stored as the
    reference stores it: its K-partitions with K and, within K's block, over
    the ``pwp_tiles`` axis (:func:`_pwp_tiles_axis`; ``data``), its columns
    with N. :func:`_phi_sharded_matmul` all-gathers the bank over that axis
    at each call, so a rank holds 1 / data of the bank its GEMM reads.

    These are the placements the forward reads, so no leaf is split over the
    ZeRO-3 ``fsdp`` dim here (a no-op under ``SERVE_RULES``, where it is
    None): under ``TRAIN_RULES`` the train step stores the trainable leaves
    at ``specs_to_shardings`` and all-gathers that dim into these."""
    rules = rules or current_rules()
    specs = lm_specs(cfg)
    out = specs_to_shardings(specs, mesh, dict(rules, fsdp=None))

    def walk(node, placed):
        for k, v in node.items():
            if isinstance(v, dict) and not k.startswith("phi_"):
                walk(v, placed[k])
            elif k in _WEIGHT_AXES and _is_gemm_weight(v):
                k_ax, n_ax = _gemm_spec_axes(v.shape, _weight_axes(k, v), mesh, rules)
                lead = _lead(v, mesh, rules)
                placed[k] = _trim(lead + (k_ax, n_ax))
                if "phi_" + k in node:
                    T = node["phi_" + k]["pwp"].shape[-3]
                    t_ax = _pwp_tiles_axis(T, k_ax, lead + (n_ax,), mesh, rules)
                    phi = {"patterns": _trim(lead + (k_ax,)),
                           "pwp": _trim(lead + (t_ax, None, n_ax)),
                           "usage": ()}
                    if "pwp_scale" in node["phi_" + k]:
                        phi["pwp_scale"] = _trim(lead + (t_ax,))
                    placed["phi_" + k] = phi

    walk(specs, out)
    return out


_LAYOUTS: dict = {}


def _layout(cfg: ModelConfig, mesh, rules) -> dict:
    """{(weight name, local (K, N)): (k_ax, n_ax)} of ``cfg`` on ``mesh``:
    how a rank tells its local GEMM weights apart (Zamba2's Mamba-2 ``wo``,
    d_inner → d_model, and its shared block's, heads × hd → d_model, are both
    row-parallel ``wo``s of other local K). Two weights of one name and local
    shape placed differently raise. Built once per config, mesh shape and
    rule table."""
    key = (cfg, tuple(mesh.axis_names), tuple(mesh.shape.items()),
           tuple(sorted((k, v) for k, v in rules.items())))
    table = _LAYOUTS.get(key)
    if table is None:
        table = {}
        for _, name, spec in _gemm_weights(lm_specs(cfg)):
            k_ax, n_ax = _gemm_spec_axes(spec.shape, _weight_axes(name, spec), mesh, rules)
            K, N = spec.shape[-2:]
            loc = (name, K // axis_size(mesh, k_ax), N // axis_size(mesh, n_ax))
            if table.setdefault(loc, (k_ax, n_ax)) != (k_ax, n_ax):
                raise ValueError(f"{cfg.name}: two {name} weights of local shape {loc[1:]} "
                                 "are placed differently")
        _LAYOUTS[key] = table
    return table


def _gemm_axes(cfg: ModelConfig, name: str, w: torch.Tensor) -> tuple:
    """(k_ax, n_ax) of the local GEMM weight ``w`` named ``name`` on the
    current mesh."""
    mesh = current_mesh()
    try:
        return _layout(cfg, mesh, current_rules())[(name, *w.shape[-2:])]
    except KeyError:
        raise ValueError(f"{cfg.name}: no {name} weight of local shape "
                         f"{tuple(w.shape[-2:])} on the mesh {mesh.shape}") from None


def _tp_sum(cfg: ModelConfig, out: torch.Tensor, name: str, w: torch.Tensor) -> torch.Tensor:
    """Complete a row-parallel GEMM: its partial products summed over the
    weight's K axis, in float32 (a no-op off a mesh and for column-parallel
    weights)."""
    mesh = current_mesh()
    if mesh is None or name not in _WEIGHT_AXES:
        return out
    k_ax, _ = _gemm_axes(cfg, name, w)
    if k_ax is None:
        return out
    return coll.all_reduce(out.to(torch.float32), mesh, k_ax).to(out.dtype)


def _enter(cfg: ModelConfig, x: torch.Tensor, name: str, w: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel GEMM (N split, K whole): replicated
    over N's axis, each rank contracting it with its columns, so its
    gradient is summed over that axis (``collectives.sum_grad``; identity
    off autograd, off a mesh and for other weights)."""
    mesh = current_mesh()
    if mesh is None or name not in _WEIGHT_AXES:
        return x
    k_ax, n_ax = _gemm_axes(cfg, name, w)
    if k_ax is not None or n_ax is None:
        return x
    return coll.sum_grad(x, mesh, n_ax)


def _phi_sharded_matmul(cfg, spikes, w, patterns, pwp, name, budget, pwp_scale=None):
    """Phi matmul of one call site; the execution policy resolves the
    lowering (the model layer never names one, except through
    ``cfg.phi.impl``).

    On a mesh every operand is this rank's shard: spikes (T, rows, ..., K)
    its rows and its K columns, the weight, patterns and bank as
    :func:`param_shardings` places them; a bank stored split over
    ``pwp_tiles`` is all-gathered over that axis first. Column-parallel weights (K whole)
    need no communication; row-parallel ones (K on ``model``: wo, w2) give
    each rank the partial sum of its K-partitions (its bank slice and its
    COO columns), and an all-reduce over K's axis, in float32 before any
    cast, completes it: the Phi analogue of Megatron row-parallelism. The
    call runs in a per-rank body (``dispatch.spmd_body``, the mesh's size),
    at site ``lm.{name}.spmd``, with the calibration histogram sliced to the
    local K-partitions (``dispatch.shard_usage_histogram``), or none where the
    site's registered histogram belongs to a bank of another length."""
    override = cfg.phi.impl if cfg.phi is not None else None
    mesh = current_mesh()
    if mesh is None:
        return dispatch.phi_matmul(spikes, w, patterns, pwp, site=f"lm.{name}",
                                   config_override=override, nnz_budget=budget,
                                   gather_dtype=cfg.compute_dtype, pwp_scale=pwp_scale)
    k_ax, _ = _gemm_axes(cfg, name, w)
    usage = dispatch.get_policy().shard_usage_for(f"lm.{name}", axis_size(mesh, k_ax),
                                                  patterns.shape[-3])
    if pwp.shape[-3] != patterns.shape[-3]:
        # the bank is stored split over pwp_tiles within K's block: gathered
        # here, the rank's GEMM reads the same bytes as from a whole copy
        t_ax = resolve_spec(("pwp_tiles",))[0]
        pwp = coll.all_gather(pwp, mesh, t_ax, dim=pwp.ndim - 3)
        if pwp_scale is not None:
            pwp_scale = coll.all_gather(pwp_scale, mesh, t_ax, dim=pwp_scale.ndim - 2)
        if pwp.shape[-3] != patterns.shape[-3]:
            raise ValueError(f"lm.{name}: a bank of {pwp.shape[-3]} K-partitions gathered over "
                             f"{t_ax!r} for {patterns.shape[-3]} patterns' partitions: the "
                             "rules in force are not the ones it was placed under")
    flat = spikes.reshape(-1, spikes.shape[-1])
    with dispatch.spmd_body(mesh.size):
        out = dispatch.phi_matmul(flat, w, patterns, pwp, site=f"lm.{name}.spmd",
                                  config_override=override, nnz_budget=budget,
                                  gather_dtype=cfg.compute_dtype, pwp_scale=pwp_scale,
                                  usage=usage)
    if k_ax is not None:
        out = coll.all_reduce(out, mesh, k_ax)
    return out.reshape(spikes.shape[:-1] + (w.shape[-1],))


def _mesh_dense_mm(cfg: ModelConfig):
    """The dense GEMM on a mesh: ``layers.default_mm`` with the row-parallel
    weights' partial products summed over their K axis."""
    def mm(a: torch.Tensor, p: dict, name: str) -> torch.Tensor:
        w = p[name]
        return _tp_sum(cfg, ll.default_mm(_enter(cfg, a, name, w), p, name), name, w)

    return mm


def make_matmul(cfg: ModelConfig):
    """Returns the GEMM implementation for this config (dense / spiking-Phi)."""
    if not cfg.spiking:
        # default dense mm; on a mesh, with the row-parallel sums
        return None if current_mesh() is None else _mesh_dense_mm(cfg)

    phi = cfg.phi or PhiConfig()
    lif = LIFConfig(decay=0.5, threshold=1.0)
    spike_impl = getattr(cfg, "spike_impl", "phi")

    def mm(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
        w = p[name]
        phi_p = p.get("phi_" + name)
        spikes = rate_code(_enter(cfg, x, name, w), phi.timesteps, lif)   # (T, ..., K)
        if phi_p is None:
            out = _tp_sum(cfg, spikes.to(cfg.compute_dtype) @ w.to(cfg.compute_dtype), name, w)
        elif spike_impl != "phi":
            # Oracle comparison mode (cfg.spike_impl names a lowering): the
            # one context where the model layer pins the impl.
            out = _tp_sum(cfg, dispatch.phi_matmul(
                spikes, w.to(torch.float32), phi_p["patterns"],
                phi_p["pwp"].to(torch.float32), site=f"lm.{name}.oracle",
                override=spike_impl), name, w)
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
        spikes = rate_code(_enter(cfg, x, name, p[name]), phi.timesteps, lif)
        out = _tp_sum(cfg, spikes @ p[name].to(torch.float32), name, p[name])
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
def _vocab_axis():
    return (resolve_spec(("vocab",)) or (None,))[0]


def _embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The token embedding rows. A vocab-parallel table (a rank holds its
    block of the vocab) looks up the tokens in its block, zeros elsewhere,
    and sums over the vocab axis."""
    emb = params["embed"]
    tok = tokens.long()
    if emb.shape[0] == cfg.vocab:
        return emb[tok]
    mesh, ax = current_mesh(), _vocab_axis()
    local = tok - mesh.index(ax) * emb.shape[0]
    hit = (local >= 0) & (local < emb.shape[0])
    rows = emb[local.clamp(0, emb.shape[0] - 1)] * hit[..., None].to(emb.dtype)
    return coll.all_reduce(rows.to(torch.float32), mesh, ax).to(emb.dtype)


def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Token + stub-frontend embedding -> (B, S_total, D) in compute dtype."""
    parts = []
    if cfg.frontend == "patches":
        parts.append(batch["patch_embeds"].to(cfg.compute_dtype))
    if cfg.frontend == "frames":
        x = batch["frame_embeds"].to(cfg.compute_dtype)
        return shard(x, "batch", "seq", "act_embed")
    tok = _embed_tokens(cfg, params, batch["tokens"]).to(cfg.compute_dtype)
    parts.append(tok)
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return shard(x, "batch", "seq", "act_embed")


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor, bd=None) -> torch.Tensor:
    """The head over the global rows. On a mesh a rank makes one device's
    call: it gathers the rows over ``bd`` (the batch axis, None where they
    are replicated), and a vocab-parallel head writes its block into zeros
    of the whole (D, V) head, keeps its block of the logits and gathers them
    over the vocab axis. The library GEMM sums in an order that depends on
    its shape, so only one device's shape gives one device's bits; the zero
    columns cost the rest of one device's head."""
    x = ll.apply_norm(cfg, params["ln_f"], x).to(cfg.compute_dtype)
    w = params["head"].to(cfg.compute_dtype)
    mesh = current_mesh()
    if mesh is None:
        return shard((x @ w).to(torch.float32), "batch", "seq", "act_vocab")
    x = coll.all_gather(x, mesh, bd, dim=0)
    if w.shape[1] == cfg.vocab:
        return (x @ w).to(torch.float32)
    ax = _vocab_axis()
    v0 = mesh.index(ax) * w.shape[1]
    full = w.new_zeros((w.shape[0], cfg.vocab))
    full[:, v0:v0 + w.shape[1]] = w
    logits = (x @ full)[..., v0:v0 + w.shape[1]].to(torch.float32)
    return coll.all_gather(logits, mesh, ax, dim=-1)


def batch_axis(batch: int):
    """The mesh axes a global batch of ``batch`` rows is split over: the
    ``batch`` rule's, or None off a mesh and where they do not divide it
    (the reference's divisibility fallback: the rows replicate)."""
    mesh = current_mesh()
    if mesh is None:
        return None
    ax = (resolve_spec(("batch",)) or (None,))[0]
    return ax if ax is not None and batch % axis_size(mesh, ax) == 0 else None


def local_rows(x: Any, bd) -> Any:
    """This rank's rows (dim 0) of a global batch tensor, or of each tensor
    of a dict, under the batch axis ``bd``."""
    if isinstance(x, dict):
        return {k: local_rows(v, bd) for k, v in x.items()}
    if bd is None or x is None:
        return x
    mesh = current_mesh()
    n = x.shape[0] // mesh.extent(bd)
    return x[mesh.index(bd) * n:(mesh.index(bd) + 1) * n]


def _forward(cfg: ModelConfig, params: dict, batch: dict, matmul=None,
             want_cache: bool = False):
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    mm = matmul if matmul is not None else make_matmul(cfg)
    return transformer.stack_prefill(cfg, params["decoder"], x, positions,
                                     matmul=mm, want_cache=want_cache)


def _batch_rows(batch: dict):
    """(batch axis, the context that declares this rank's block of the
    batch's rows, this rank's rows of ``batch``)."""
    rows = next(iter(batch.values())).shape[0]
    bd = batch_axis(rows)
    return bd, _row_block(bd, rows), local_rows(batch, bd)


def _row_block(bd, rows: int):
    """The context that declares this rank's block of a global batch of
    ``rows`` rows split over ``bd`` (nothing where the rows replicate)."""
    if bd is None:
        return contextlib.nullcontext()
    mesh = current_mesh()
    n = rows // mesh.extent(bd)
    return use_batch_rows(rows, mesh.index(bd) * n)


def train_logits(cfg: ModelConfig, params: dict, batch: dict, matmul=None) -> torch.Tensor:
    bd, rows, batch = _batch_rows(batch)
    with rows:
        x, _ = _forward(cfg, params, batch, matmul)
    return _logits(cfg, params, x, bd)


def train_loss(cfg: ModelConfig, params: dict, batch: dict, matmul=None) -> torch.Tensor:
    """Masked next-token cross-entropy. labels: (B, S_total) int, -1 = pad.
    On a mesh: :func:`_vocab_parallel_loss`."""
    if current_mesh() is not None:
        return _vocab_parallel_loss(cfg, params, batch, matmul)
    logits = train_logits(cfg, params, batch, matmul)
    labels = batch["labels"].long()
    logp = F.log_softmax(logits, dim=-1)
    take = torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return -(take * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _vocab_parallel_loss(cfg: ModelConfig, params: dict, batch: dict,
                         matmul=None) -> torch.Tensor:
    """:func:`train_loss` on a mesh: the global batch's masked mean, the
    same on every rank. A rank runs its rows (the ``batch`` axes) and
    multiplies them by its block of a vocab-parallel head, never gathering
    the logits: the row maxima, the sums of exponentials and the target
    logits are reduced over the vocab axis (the maxima carry no gradient),
    and the masked sum and the count over the batch axes. The head's input
    is replicated over the vocab axis (``collectives.sum_grad``)."""
    mesh = current_mesh()
    bd, rows, local = _batch_rows(batch)
    with rows:
        x, _ = _forward(cfg, params, local, matmul)
    w = params["head"].to(cfg.compute_dtype)
    ax = _vocab_axis() if w.shape[1] != cfg.vocab else None
    h = ll.apply_norm(cfg, params["ln_f"], x).to(cfg.compute_dtype)
    logits = (coll.sum_grad(h, mesh, ax) @ w).to(torch.float32)        # (b, S, V / n)
    top = coll.all_reduce(logits.detach().amax(-1), mesh, ax, op="max")
    lse = top + torch.log(coll.all_reduce(torch.exp(logits - top[..., None]).sum(-1),
                                          mesh, ax))
    labels = local["labels"].long()
    tgt = labels.clamp(min=0) - (mesh.index(ax) * w.shape[1] if ax is not None else 0)
    hit = (tgt >= 0) & (tgt < w.shape[1])
    take = torch.gather(logits, -1, tgt.clamp(0, w.shape[1] - 1)[..., None])[..., 0]
    take = coll.all_reduce(take * hit.to(torch.float32), mesh, ax)
    mask = (labels >= 0).to(torch.float32)
    total = coll.all_reduce(((lse - take) * mask).sum(), mesh, bd)
    return total / torch.clamp(coll.all_reduce(mask.sum(), mesh, bd), min=1.0)


def prefill(cfg: ModelConfig, params: dict, batch: dict, matmul=None):
    """Returns (last-position logits (B, V), decode state). On a mesh the
    decode state is this rank's: its rows and heads."""
    bd, rows, batch = _batch_rows(batch)
    with rows:
        x, caches = _forward(cfg, params, batch, matmul, want_cache=True)
    logits = _logits(cfg, params, x[:, -1:], bd)
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
    bd, rows, batch = _batch_rows(batch)
    with rows:
        x, caches = _forward(cfg, params, batch, matmul, want_cache=True)
    idx = local_rows(last_pos, bd).to(device=x.device, dtype=torch.long)[:, None, None]
    sel = torch.gather(x, 1, idx.expand(x.shape[0], 1, x.shape[2]))
    logits = _logits(cfg, params, sel, bd)
    return logits[:, 0], caches


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor, pos: torch.Tensor,
                caches, embeds: torch.Tensor | None = None, matmul=None):
    """token (B,) int (or embeds (B, D) for frame frontends); pos (B,) int.
    The caches are written in place and returned. On a mesh, ``token``,
    ``pos`` and ``embeds`` are global and the caches this rank's."""
    rows = (embeds if embeds is not None else token).shape[0]
    bd = batch_axis(rows)
    token, pos, embeds = (local_rows(t, bd) for t in (token, pos, embeds))
    if embeds is not None:
        x = embeds[:, None].to(cfg.compute_dtype)
    else:
        x = _embed_tokens(cfg, params, token)[:, None].to(cfg.compute_dtype)
    x = shard(x, "batch", None, "act_embed")
    mm = matmul if matmul is not None else make_matmul(cfg)
    with _row_block(bd, rows):
        x, new_caches = transformer.stack_decode(cfg, params["decoder"], x, pos, caches,
                                                 matmul=mm)
    logits = _logits(cfg, params, x, bd)
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
    On a mesh, ``token``, ``pos`` and ``page_table`` are global and the
    pools this rank's; its rows of the table are cut as ``token``'s.
    """
    rows = token.shape[0]
    bd = batch_axis(rows)
    token, pos, page_table = (local_rows(t, bd) for t in (token, pos, page_table))
    x = _embed_tokens(cfg, params, token)[:, None].to(cfg.compute_dtype)
    x = shard(x, "batch", None, "act_embed")
    mm = matmul if matmul is not None else make_matmul(cfg)
    with _row_block(bd, rows):
        x, new_pools = transformer.stack_decode_paged(
            cfg, params["decoder"], x, pos, pools, page_table, matmul=mm)
    logits = _logits(cfg, params, x, bd)
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


def paged_state_shardings(cfg: ModelConfig, specs: Any, mesh, rules: dict) -> list[tuple]:
    """The placement of each pool leaf, (n_groups, P + 1, page_size, Hkv,
    hd), in ``state_leaves`` order: its KV heads as the contiguous cache
    places them (``train.step.state_sharding_for_leaf``), every page on
    every rank. The page table is global and the same on every rank, and a
    rank reads only its rows' pages: the pages the other ``data`` ranks'
    slots write go stale here, behind the attention mask. Raises where the
    heads' axis does not split the KV heads (a rank's K and V hold its
    block of them)."""
    from repro_torch.train.step import state_sharding_for_leaf

    tp = (resolve_spec(("heads",), rules, mesh) or (None,))[0]

    def one(s):
        place = list(state_sharding_for_leaf(cfg, tuple(s.shape), mesh, rules,
                                             s.shape[1], batch_dim=1))
        if place[3] is None and axis_size(mesh, tp) > 1:
            raise ValueError(f"{cfg.name}: {cfg.kv_heads_padded} KV heads do not split over "
                             f"{tp} = {axis_size(mesh, tp)}; the page pools cannot be placed")
        place[1] = None
        return tuple(place)

    return [one(s) for s in state_leaves(specs)]


def init_paged_state(cfg: ModelConfig, num_pages: int, page_size: int,
                     device: str | torch.device | None = None, mesh=None,
                     rules: dict | None = None) -> tuple[Any, list | None]:
    """Zero page pools (paged serving cold start): on a mesh, this rank's
    shard of each (:func:`paged_state_shardings`). Returns (pools, the
    leaves' placements in ``state_leaves`` order), the placements None off
    a mesh."""
    specs = paged_state_specs(cfg, num_pages, page_size)
    if mesh is None:
        return _zeros(specs, resolve_device(device)), None
    placements = paged_state_shardings(cfg, specs, mesh, rules or SERVE_RULES)
    it = iter(placements)
    local = map_state(lambda s: TensorSpec(local_shape(s.shape, next(it), mesh), s.dtype),
                      specs)
    return _zeros(local, mesh.device if device is None else device), placements
