"""int8 error-feedback gradient compression for the cross-pod hop (port of
``repro/train/grad_compress.py``).

At 2+ pods the data-parallel gradient reduction crosses the slow link
between pods. The standard trick (1-bit Adam lineage; Seide et al.,
Karimireddy et al.): reduce at full precision *within* the pod, but exchange
int8 quantised gradients *across* pods, feeding the quantisation error back
into the next step so convergence is preserved. The residual is carried in
the optimizer state under ``"ef"``.

The reference runs the pod's gradient in a ``shard_map`` manual over
``pod`` only, its other axes left to ``pjit``. Here each rank runs the loss
on its pod's block of the batch under the rules with ``pod`` stripped, so
every intra-pod collective (the ``data`` reduction, the ``model``
partial sums) stays inside the pod; then each leaf goes through
:func:`_compress_reduce`: the int8 values and their scale are all-gathered
over ``pod`` (one byte an entry on the wire) and every rank sums the pods'
dequantised values. A rank holds a shard of a leaf, and the reference's
scale is ``max|x|`` over the whole leaf, so the shard's maximum is
all-reduced over the axes the leaf is split over before quantising: every
shard of a leaf quantises on one scale, as there.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.train.step import _tree_map, value_and_grad


def _quantize(x: torch.Tensor, mesh=None, ax=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale) of ``x``: the scale ``max|x| / 127`` over
    the whole leaf (the shard's maximum reduced over ``ax``, the leaf's split
    axes), the values rounded to nearest even and clipped to ±127."""
    top = coll.all_reduce(torch.max(torch.abs(x)), mesh, ax, op="max")
    scale = top / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _compress_reduce(g: torch.Tensor, e: torch.Tensor, npod: int, mesh, ax=None):
    """Per-pod gradient + error feedback -> (cross-pod int8 mean, new error,
    the scale)."""
    x = g.to(torch.float32) + e
    q, scale = _quantize(x, mesh, ax)
    new_e = x - q.to(torch.float32) * scale
    qs = coll.all_gather(q[None], mesh, "pod", 0)
    scales = coll.all_gather(scale.reshape(1), mesh, "pod", 0)
    tot = qs[0].to(torch.float32) * scales[0]
    for p in range(1, npod):
        tot = tot + qs[p].to(torch.float32) * scales[p]
    return (tot / npod).to(g.dtype), new_e, scale


def _strip_pod(v):
    if isinstance(v, tuple):
        out = tuple(a for a in v if a != "pod")
        return out if len(out) > 1 else (out[0] if out else None)
    return None if v == "pod" else v


def _split_axes(placement) -> tuple[str, ...] | None:
    axes = tuple(a for ent in placement for a in shd.axis_names_of(ent))
    return axes or None


def pod_compressed_grads(loss_fn: Callable, params: dict, batch: dict, ef: dict, mesh, *,
                         placements: Any = None, stats: dict | None = None):
    """Returns (loss, grads, new_ef): grads are the cross-pod int8-EF mean of
    per-pod gradients; loss is the cross-pod mean loss.

    ``loss_fn(params, batch)`` must be a *mean* over the batch it sees, a
    scalar tensor that autograd differentiates; it runs on this rank under
    the current rules with ``pod`` stripped, on its pod's block of the rows
    of ``batch`` (global, dim 0 split over ``pod``), and does its own
    intra-pod collectives. ``params`` and ``ef`` are this rank's shards, placed
    as ``placements`` (a tree like ``params``; default: whole on every rank).
    ``stats``, if given, receives each leaf's scale by its key path."""
    npod = mesh.shape["pod"]
    rows = next(iter(batch.values())).shape[0]
    if rows % npod:
        raise ValueError(f"a batch of {rows} rows does not split over {npod} pods")
    n, p = rows // npod, mesh.coords["pod"]
    pod_batch = {k: v[p * n:(p + 1) * n] for k, v in batch.items()}
    inner_rules = {k: _strip_pod(v) for k, v in shd.current_rules().items()}
    with shd.use_rules(inner_rules, mesh):
        loss, grads = value_and_grad(loss_fn, params, pod_batch)
    if placements is None:
        placements = _tree_map(lambda _: (), params)
    out = _tree_map(lambda g, e, pl: _compress_reduce(g, e, npod, mesh, _split_axes(pl)),
               grads, ef, placements)

    def part(node, i):
        if isinstance(node, dict):
            return {k: part(v, i) for k, v in node.items()}
        return node[i]

    if stats is not None:
        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            else:
                stats["/".join(path)] = float(node[2])
        walk(out, ())
    loss = coll.all_reduce(loss, mesh, "pod") / npod
    return loss, part(out, 0), part(out, 1)
