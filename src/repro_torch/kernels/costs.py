"""The work of each hand-written kernel: (operations, bytes) of one launch.

One count serves two readers: the least-time bounds ``chip_smoke.py`` prints
beside each kernel's time on the card, and the step costs of the dry run
(``distributed.cost_analysis``, ``launch.dryrun``). Each function takes a
launch's shapes (and, where the work depends on the data, what the data
needs) and returns ``(ops, bytes)``: the bytes the function must move (each
input read once, each output written once) and the operations it does, in
float32 on the CUDA cores unless :data:`OPS_RATE` names another rate. The
integer match work of the fused and attention kernels is not counted: the
card's table of peaks has no integer CUDA-core rate.

Shape-only launches. A dry run traces a step on fake tensors
(``torch._subclasses.fake_tensor``), which have shapes and no data. Under
it each kernel wrapper checks and allocates as for a real launch, skips the
launch and leaves its ``.launches`` as it was (nothing launched), and
:func:`record` logs the launch's name, shapes and cost for the
:func:`recording` contexts open: a dry run's kernel plan is that log. On real tensors the wrappers launch as
before; :func:`traced` is one ``isinstance`` test.
"""
from __future__ import annotations

import contextlib
import dataclasses

from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.core.hwconst import F32_FLOP_PER_S, INT8_OPS_PER_S

# The rate each kernel's operations run at, where it is not the float32
# CUDA-core peak: the matcher scores on the int8 tensor cores.
OPS_RATE = {"matcher_cuda": INT8_OPS_PER_S}

# L2 residual entries per (row, K) of a traced launch, whose data does not
# exist: ``configs.phi_variant``'s default static L2 capacity (the paper's
# measured density of about 3 %, with a margin).
DRY_RUN_L2_DENSITY = 0.04


def rate(name: str) -> float:
    """Operations per second of kernel ``name`` (a wrapper's ``__name__``)."""
    return OPS_RATE.get(name, F32_FLOP_PER_S)


# ------------------------------------------------------------ the counts ---
def fused(M: int, K: int, N: int, T: int, q: int, k: int, l2_entries: int,
          pwp_rows: int | None = None, w_rows: int | None = None,
          l1_pairs: int | None = None, pwp_bytes: int = 4) -> tuple[int, int]:
    """One fused Phi matmul (any of the three fused kernels): bytes of a,
    the patterns, the PWP rows and scales the call needs, the weight rows,
    the output and the per-256-row counters; operations L1 (a multiply and
    an add per matched (row, partition) pair and column), L2 (an add per
    residual entry and column) and the final add. ``pwp_rows`` defaults to
    the whole bank, T·(q+1), ``w_rows`` to K, ``l1_pairs`` to M·T;
    ``pwp_bytes`` is a bank element's size (4: the bounds count it as
    float32)."""
    pwp_rows = T * (q + 1) if pwp_rows is None else pwp_rows
    w_rows = K if w_rows is None else w_rows
    l1_pairs = M * T if l1_pairs is None else l1_pairs
    nbytes = 4 * M * K + T * q * k + pwp_bytes * pwp_rows * N + 4 * pwp_rows \
        + 4 * w_rows * N + 4 * M * N + 4 * -(-M // 256)
    ops = 2 * l1_pairs * N + l2_entries * N + M * N
    return ops, nbytes


def fused_needed(a, patterns, N: int) -> tuple[int, int]:
    """:func:`fused` counting what the rows ``a`` (M, K) need: the PWP rows
    of the (partition, pattern) pairs they match, the weight rows their
    residual touches, their matched pairs and residual entries."""
    import torch

    from repro_torch.core.assign import assign_patterns

    T, q, k = patterns.shape
    idx, res = assign_patterns(a, patterns)
    used = idx < q
    pairs = idx.long() + torch.arange(T, device=a.device) * (q + 1)
    return fused(a.shape[0], a.shape[1], N, T, q, k, int((res != 0).sum()),
                 pwp_rows=int(torch.unique(pairs[used]).numel()),
                 w_rows=int((res != 0).any(0).sum()), l1_pairs=int(used.sum()))


def lif_sequence(T: int, n: int) -> tuple[int, int]:
    """The LIF sequence over T steps of n neurons: the currents read and the
    spikes written once; three operations per neuron-step."""
    return 3 * T * n, 8 * T * n


def lif_step(n: int) -> tuple[int, int]:
    """One LIF step of n neurons: v and x read, the spike and v' written;
    three operations per neuron."""
    return 3 * n, 16 * n


def phi_attention(B: int, S: int, H: int, D: int, T: int, qp: int, kp: int, nq: int,
                  l2_entries: int) -> tuple[int, int]:
    """One Phi flash-attention call: q, k, v and the packed bank read once,
    out and the (B·H, nq) l2_nnz written once; per score the L1 sum (T adds),
    L1 + L2, the ragged tail (2 per tail feature), the scale, the softmax
    (max, subtract, exp, sum: 4) and p.V (2 D); per residual entry of a K
    row an add for every query row (``l2_entries`` counts each K row's
    residual once); per output the division by the denominator."""
    BH = B * H
    nbytes = 16 * B * S * H * D + 8 * T * qp + 4 * BH * nq
    scores = BH * S * S
    ops = scores * (T + 1 + 2 * (D - T * kp) + 1 + 4 + 2 * D) + l2_entries * S + BH * S * D
    return ops, nbytes


def kept_scores(S: int, causal: bool, window: int | None = None,
                chunk: int | None = None) -> int:
    """Scores one head's attention keeps: all S² without a mask, S(S+1)/2
    causal, fewer under a sliding window or a chunked-local mask."""
    if not causal:
        return S * S
    if chunk is not None:
        n, r = divmod(S, chunk)
        return n * chunk * (chunk + 1) // 2 + r * (r + 1) // 2
    if window is not None and window < S:
        return window * (window + 1) // 2 + (S - window) * window
    return S * (S + 1) // 2


def dense_attention(B: int, S: int, H: int, D: int, causal: bool = True,
                    window: int | None = None, chunk: int | None = None) -> tuple[int, int]:
    """One dense attention: q, k, v read and out written once (float32); per
    score the mask keeps (:func:`kept_scores`) q.k (2 D), the softmax (4) and
    p.V (2 D), and a division per output."""
    nbytes = 16 * B * S * H * D
    ops = B * H * kept_scores(S, causal, window, chunk) * (4 * D + 4) + B * H * S * D
    return ops, nbytes


def decode_attention(B: int, Hq: int, Hkv: int, D: int, kv_rows: int, q_bytes: int,
                     kv_bytes: int) -> tuple[int, int]:
    """One-token decode attention over ``kv_rows`` valid cache rows in all
    (the rows each batch row's mask keeps, summed over the rows): q read and
    the output written once, each KV head's kept K and V rows read once;
    per (Q head, kept row) q.k (2 D), the scale and the softmax (4) and p.V
    (2 D), and a division per output. The wrapper on fake tensors, whose
    positions hold no values, passes every cache row (B * Smax)."""
    nbytes = 2 * B * Hq * D * q_bytes + 2 * kv_rows * Hkv * D * kv_bytes
    ops = Hq * kv_rows * (4 * D + 5) + B * Hq * D
    return ops, nbytes


def matcher(M: int, K: int, T: int, q: int, k: int) -> tuple[int, int]:
    """The matcher: a and the packed bank read, idx and the int8 residual
    written; the scores as int8 tensor-core work, a multiply and an add per
    row, partition, pattern and bit (:data:`OPS_RATE`)."""
    return 2 * M * T * q * k, 4 * M * K + 8 * T * q + 4 * M * T + M * K


def l1_gather(M: int, T: int, N: int, rows_named: int, pwp_bytes: int) -> tuple[int, int]:
    """The L1 gather: idx read, the bank rows the indices name (each distinct
    (t, index) row once, ``rows_named``) and the output written; T - 1 adds
    per output."""
    return M * N * (T - 1), 4 * M * T + rows_named * N * pwp_bytes + 4 * M * N


def l2_spmm(entries: int, w_rows: int, N: int, out_rows: int) -> tuple[int, int]:
    """The L2 spmm: the real entries read (4 + 4 + 1 bytes), the weight rows
    they name and the (out_rows, N) output written; an add per entry and
    column."""
    return entries * N, 9 * entries + 4 * w_rows * N + 4 * out_rows * N


# ------------------------------------------------------- traced launches ---
@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch a dry run traced: the wrapper's name, its operands'
    shapes, and :func:`fused` & co.'s count for them."""

    name: str
    shapes: tuple
    ops: int
    bytes: int


_logs: list[list[Launch]] = []


def traced(x) -> bool:
    """True where ``x`` is a fake tensor: a dry run traces the step, and the
    wrapper skips its launch."""
    return isinstance(x, FakeTensor)


@contextlib.contextmanager
def recording():
    """A list that collects every launch :func:`record` logs while it is open."""
    log: list[Launch] = []
    _logs.append(log)
    try:
        yield log
    finally:
        _logs.remove(log)


def record(name: str, tensors, cost: tuple[int, int]) -> None:
    """Log a traced launch of kernel ``name`` on ``tensors`` (its operands)
    costing ``cost`` = (ops, bytes) in every open :func:`recording`."""
    if not _logs:
        return
    launch = Launch(name, tuple(tuple(t.shape) for t in tensors if t is not None), *cost)
    for log in _logs:
        log.append(launch)
