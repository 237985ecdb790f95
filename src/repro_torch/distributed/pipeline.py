"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro/distributed/pipeline.py``).

``pipeline_apply`` runs a stage function over the ``n_stages`` ranks of a
mesh axis: the rank at index s holds the layer slice ``params[s]``;
microbatches enter stage 0 and flow stage to stage on a classic GPipe
fill/drain schedule of ``n_micro + n_stages - 1`` ticks. The reference's
``ppermute`` to the next stage is a :func:`~repro_torch.distributed.
collectives.send` to it and a ``recv`` from the previous one. Where the
reference's scan runs every stage at every tick (on zeros or stale values
outside a stage's ``n_micro`` ticks) and keeps only the valid outputs, a
rank here computes only at its valid ticks (t in [s, s + n_micro)): the same
outputs, without the bubble's work. The last stage's outputs reach every
rank by the reference's masked sum over the axis. Forward only.

Bubble fraction = (S−1)/(M+S−1).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed import collectives as coll


def pipeline_apply(stage_fn: Callable, params: Any, x_micro: torch.Tensor, mesh,
                   axis: str = "pod") -> torch.Tensor:
    """Run a layer-sliced computation as a pipeline over ``axis``.

    stage_fn(stage_params, x) -> y           (one stage's computation; y
                                              shaped and typed as x)
    params: this rank's slice of a tree stacked on a leading axis of
            n_stages (placement ``(axis,)``: leading dim 1)
    x_micro: (n_micro, micro_batch, ...) microbatched input (the same on
             every rank)
    Returns (n_micro, micro_batch, ...) outputs, the same on every rank.
    """
    S = mesh.shape[axis]
    M = x_micro.shape[0]
    sid = mesh.coords[axis]

    def squeeze(tree):
        if isinstance(tree, dict):
            return {k: squeeze(v) for k, v in tree.items()}
        return tree[0]

    p_loc = squeeze(params)
    outs = torch.zeros_like(x_micro)
    for t in range(M + S - 1):
        m = t - sid                         # the microbatch this stage holds at tick t
        if not 0 <= m < M:
            continue
        x_in = x_micro[m] if sid == 0 else coll.recv(x_micro[0], mesh, axis, sid - 1)
        y = stage_fn(p_loc, x_in)
        if sid < S - 1:
            coll.send(y, mesh, axis, sid + 1)
        else:
            outs[m] = y
    # only the last stage holds real outputs (the others' are zeros):
    # broadcast via the masked sum
    return coll.all_reduce(outs, mesh, axis)


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
