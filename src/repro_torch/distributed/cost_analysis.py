"""A step's per-rank cost, counted while it runs: FLOPs, bytes, collectives,
live memory and kernel launches, and the roofline they give on the H100.

Port of ``repro/distributed/hlo_analysis.py``. The reference compiles a step
with XLA and walks the partitioned HLO text: dot FLOPs, the operand and
result bytes of every top-level op (``bytes``) and of the fusions holding a
major op (``bytes_fused``), and the result bytes of each collective by kind.
The port has no compiler: :class:`StepCost` is a ``TorchDispatchMode`` that
sees every aten op the step runs (on fake tensors in a dry run, on real ones
elsewhere) and counts

* **flops**: the matmul-class ops by ``torch.utils.flop_counter``'s formulas
  (a ``FlopCounterMode`` runs inside, so the count is its count), plus each
  hand-written kernel's operations from ``kernels.costs`` (``ops_kernels``);
* **bytes_raw**: operands and results of every aten op (a mutated operand
  once, as the result), views and allocations free: the reference's
  ``bytes`` at the granularity of eager ops;
* **bytes**: the same over the ops of the reference's major-op classes
  (:data:`MAJOR_ATEN` maps aten onto them), plus every kernel launch:
  its ``bytes_fused``, elementwise work taken as fused into its neighbours;
* **collectives**: result bytes and calls by the reference's kinds, read
  from the mesh's ``results`` (``distributed.collectives``);
* **peak_live_bytes**: the most bytes of tensor storage alive at once.

:class:`Roofline` keeps the reference's fields, properties and ``as_dict``
keys on the H100 SXM's data-sheet rates (``core.hwconst``): the aten FLOPs
against the dense bf16 tensor-core peak for a bf16 compute dtype and the
float32 one otherwise (the port keeps TF32 off), each kernel's operations
at its own rate (``kernels.costs.rate``), bytes against HBM, collective
bytes against NVLink's rate in one direction.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.hwconst import (
    BF16_FLOP_PER_S, F32_FLOP_PER_S, HBM_BYTES_PER_S, NVLINK_DIR_BYTES_PER_S)
from repro_torch.kernels import costs
from repro_torch.utils import tree_bytes

# The reference's collective kinds, in its order.
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# aten ops (by packet name) of each of the reference's major-op classes
# (``hlo_analysis.MAJOR_OPS``: a fusion holding one counts in its
# ``bytes_fused``). A slice is a view here and moves no bytes
# (``dynamic-slice`` has no aten op); writing into one is a ``copy_``
# (``dynamic-update-slice``).
MAJOR_ATEN = {
    "dot": ("mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "vdot", "mv", "addmv",
            "_scaled_mm", "_scaled_dot_product_flash_attention",
            "_scaled_dot_product_efficient_attention", "_scaled_dot_product_cudnn_attention",
            "_scaled_dot_product_flash_attention_for_cpu"),
    "convolution": ("convolution", "_convolution", "convolution_backward"),
    "reduce": ("sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
               "logsumexp", "var", "std", "var_mean", "std_mean", "norm",
               "linalg_vector_norm", "any", "all", "_softmax", "_log_softmax",
               "_softmax_backward_data", "_log_softmax_backward_data", "aminmax"),
    "reduce-window": ("avg_pool2d", "max_pool2d_with_indices", "cumsum", "cumprod",
                      "_adaptive_avg_pool2d", "avg_pool2d_backward"),
    "gather": ("index", "gather", "index_select", "embedding", "take", "embedding_dense_backward"),
    "scatter": ("scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
                "scatter_reduce_", "index_put", "index_put_", "_index_put_impl_",
                "index_add", "index_add_", "index_copy", "index_copy_"),
    "dynamic-update-slice": ("copy_", "slice_scatter", "select_scatter"),
    "sort": ("sort", "topk", "argsort", "kthvalue", "msort"),
    "rng": ("rand", "randn", "randint", "normal", "normal_", "uniform_", "bernoulli",
            "bernoulli_", "random_", "multinomial", "native_dropout"),
    "cholesky": ("linalg_cholesky_ex", "cholesky"),
    "triangular-solve": ("triangular_solve", "linalg_solve_triangular"),
    "select-and-scatter": ("max_pool2d_with_indices_backward",),
}
_MAJOR = {name for names in MAJOR_ATEN.values() for name in names}
# Ops that move no bytes: aliases and allocations.
_FREE = {"detach", "alias", "lift_fresh", "_unsafe_view", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided", "set_", "resize_",
         "_local_scalar_dense"}


def _tensors(tree: Any) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """The byte and live-storage counts of :class:`StepCost`."""

    def __init__(self, owner: "StepCost"):
        super().__init__()
        self.owner = owner

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":       # device queries, collectives (counted apart)
            return out
        name = func.__name__.split(".")[0]
        own = self.owner
        own.ops += 1
        outs = _tensors(out)
        if not (func.is_view or name in _FREE):
            written = {id(t) for t in outs}
            nbytes = sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in _tensors((args, kwargs)) if id(t) not in written)
            own.bytes_raw += nbytes
            if name in _MAJOR:
                own.bytes_aten_major += nbytes
        for t in outs:
            own._track(t)
        return out


class StepCost:
    """Counts a step's cost per rank while it runs (see the module's note).

    ``with StepCost(mesh, args) as c: step(*args)``; ``args`` are the step's
    inputs (``argument_bytes``: ``utils.tree_bytes``), alive throughout, their
    storages live from the start (``live_at_start``); ``mesh`` is the rank's
    mesh, whose ``results`` give the collectives (None off a mesh)."""

    def __init__(self, mesh=None, args: Any = ()):
        self.mesh = mesh
        self.args = args
        self.ops = 0
        self.bytes_raw = 0
        self.bytes_aten_major = 0
        self.flops_aten = 0
        self.launches: list[costs.Launch] = []
        self.collectives: dict[str, int] = {}
        self.collective_calls: dict[str, int] = {}
        self.argument_bytes = 0
        self.live_at_start = 0
        self.peak_live_bytes = 0
        self._live: dict[int, int] = {}
        self._live_bytes = 0

    # ------------------------------------------------------------- storage --
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self._live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    # ------------------------------------------------------------- context --
    def __enter__(self) -> "StepCost":
        from torch.utils.flop_counter import FlopCounterMode

        for t in _tensors(self.args):
            self._track(t)
        self.argument_bytes = tree_bytes(self.args)
        self.live_at_start = self._live_bytes
        self._before = {k: list(v) for k, v in (self.mesh.results if self.mesh else {}).items()}
        self._rec = costs.recording()
        self._log = self._rec.__enter__()
        self._counter = _Counter(self)
        self._counter.__enter__()
        self._flops = FlopCounterMode(display=False)
        self._flops.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._flops.__exit__(*exc)
        self._counter.__exit__(*exc)
        self._rec.__exit__(*exc)
        self.flops_aten = self._flops.get_total_flops()
        self.launches = list(self._log)
        after = self.mesh.results if self.mesh else {}
        for kind in COLLECTIVES:
            calls, nbytes = after.get(kind, [0, 0])
            c0, b0 = self._before.get(kind, [0, 0])
            self.collectives[kind] = nbytes - b0
            self.collective_calls[kind] = calls - c0

    # ------------------------------------------------------------- results --
    @property
    def ops_kernels(self) -> int:
        """The hand-written kernels' operations (``kernels.costs``)."""
        return sum(x.ops for x in self.launches)

    @property
    def flops(self) -> int:
        return self.flops_aten + self.ops_kernels

    @property
    def bytes_kernels(self) -> int:
        return sum(x.bytes for x in self.launches)

    @property
    def bytes(self) -> int:
        """The roofline's bytes: major aten ops and every kernel launch."""
        return self.bytes_aten_major + self.bytes_kernels

    @property
    def bytes_raw_total(self) -> int:
        """Every aten op's bytes and every kernel launch's."""
        return self.bytes_raw + self.bytes_kernels

    @property
    def kernel_s(self) -> float:
        """Seconds the kernels' operations take at their rates."""
        return sum(x.ops / costs.rate(x.name) for x in self.launches)

    def launch_counts(self) -> dict[str, int]:
        """Launches of each kernel wrapper, by name."""
        out: dict[str, int] = {}
        for x in self.launches:
            out[x.name] = out.get(x.name, 0) + 1
        return dict(sorted(out.items()))

    def roofline(self, chips: int, model_flops: float, compute_dtype) -> "Roofline":
        return Roofline(flops_per_dev=float(self.flops), bytes_per_dev=float(self.bytes),
                        coll_bytes_per_dev=float(sum(self.collectives.values())), chips=chips,
                        model_flops=model_flops, bytes_raw_per_dev=float(self.bytes_raw_total),
                        flops_kernels_per_dev=float(self.ops_kernels),
                        kernel_compute_s=self.kernel_s, peak_flops=peak_flops(compute_dtype))


def peak_flops(compute_dtype) -> float:
    """The aten FLOP rate the roofline takes: the bf16 tensor cores for a
    bf16 compute dtype, float32 outside the tensor cores otherwise (TF32 is
    off in the port)."""
    return BF16_FLOP_PER_S if compute_dtype == torch.bfloat16 else F32_FLOP_PER_S


@dataclasses.dataclass
class Roofline:
    """The reference's roofline terms on the H100: each term is per-rank work
    over a per-card rate; ``kernel_compute_s`` is the hand-written kernels'
    share of the compute term, each at its own rate, ``peak_flops`` the
    rate of the rest."""

    flops_per_dev: float
    bytes_per_dev: float         # major aten ops + kernel launches — the roofline term
    coll_bytes_per_dev: float
    chips: int
    model_flops: float = 0.0     # 6·N·D (train) or 2·N_active·tokens (serve)
    bytes_raw_per_dev: float = 0.0  # every aten op's operands and result, kernels too
    flops_kernels_per_dev: float = 0.0
    kernel_compute_s: float = 0.0
    peak_flops: float = F32_FLOP_PER_S

    @property
    def compute_s(self) -> float:
        aten = self.flops_per_dev - self.flops_kernels_per_dev
        return aten / self.peak_flops + self.kernel_compute_s

    @property
    def memory_s(self) -> float:
        return self.bytes_per_dev / HBM_BYTES_PER_S

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_dev / NVLINK_DIR_BYTES_PER_S

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time = the dominant term (perfect overlap model)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / global counted FLOPs — remat/padding/waste detector."""
        tot = self.flops_per_dev * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilisation at the roofline step time."""
        denom = self.step_s * self.chips * self.peak_flops
        return self.model_flops / denom if denom else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "bytes_raw_per_dev": self.bytes_raw_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_s": self.step_s,
            "useful_ratio": self.useful_ratio,
            "mfu": self.mfu,
            "flops_kernels_per_dev": self.flops_kernels_per_dev,
            "kernel_compute_s": self.kernel_compute_s,
            "peak_flops": self.peak_flops,
        }
