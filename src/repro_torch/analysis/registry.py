"""Contract registry: one entry per hand-written kernel or plain lowering of
the port, doubling as a map of its kernel surface.

Every lowering the execution policy can resolve (``kernels.IMPLS``,
``kernels.ATTN_IMPLS``) and the two kernels outside it (the LIF sequence and
the decode attention) must be covered by an entry: :func:`_assert_complete`
runs at import, so a new lowering cannot ship unchecked. An entry mirrors its
kernel's launch in Python (``csrc/*.cu``'s grid, tile and guards), names its
counters and shared-memory model, and knows the library export that holds
the mirror against the built kernel on the card.

The shape matrix keeps a non-divisible extent in every dimension: rows (M,
S, the LIF's n), columns (N), partitions (T), patterns (q), head size (D) and
cache length (Smax).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

from repro_torch.analysis.contracts import (
    ContractFinding, Cover, check_counter, check_coverage, check_plan, check_shape,
    check_smem, check_spills, ptxas_spills)
from repro_torch.utils import cdiv


# ------------------------------------------------------------ shape matrix --
@dataclasses.dataclass(frozen=True)
class MatmulCase:
    name: str
    M: int
    K: int
    N: int
    T: int
    q: int

    @property
    def k(self) -> int:
        return self.K // self.T


@dataclasses.dataclass(frozen=True)
class AttnCase:
    name: str
    B: int
    S: int
    H: int
    D: int
    T: int
    qp: int
    kp: int


@dataclasses.dataclass(frozen=True)
class DecodeCase:
    name: str
    B: int
    Smax: int
    Hq: int
    Hkv: int
    D: int


@dataclasses.dataclass(frozen=True)
class LifCase:
    name: str
    T: int
    n: int


# A divisible base; M, N, T and q off every tile (293 rows, 130 columns, 15
# partitions of 24 patterns); a long K (T = 100 >= ops.STREAM_MIN_T: the
# streaming kernel's territory) with N off the 128-column tile.
MATMUL_CASES = (
    MatmulCase("mm_base", M=256, K=256, N=256, T=16, q=16),
    MatmulCase("mm_tail", M=293, K=240, N=130, T=15, q=24),
    MatmulCase("mm_bigk", M=100, K=1600, N=200, T=100, q=128),
)
# A divisible base; S, H, D and the bank off every block (S = 200, D = 40 with
# a dense tail of 8 features).
ATTN_CASES = (
    AttnCase("attn_base", B=1, S=256, H=2, D=64, T=4, qp=8, kp=16),
    AttnCase("attn_tail", B=3, S=200, H=3, D=40, T=2, qp=12, kp=16),
)
# OLMo-1B's decode shape, and a cache length no chunk divides at GQA with
# a head size of 120 (H2O-Danube3's).
DECODE_CASES = (
    DecodeCase("dec_base", B=4, Smax=256, Hq=16, Hkv=16, D=128),
    DecodeCase("dec_tail", B=3, Smax=200, Hq=8, Hkv=2, D=120),
)
# n off the 256-thread block, and past the grid's cap (a grid-stride loop).
LIF_CASES = (
    LifCase("lif_tail", T=4, n=1000),
    LifCase("lif_stride", T=2, n=132 * 16 * 256 + 7),
)
PREFETCH_P_ACTIVE = 8


@dataclasses.dataclass(frozen=True)
class KernelContract:
    name: str
    covers: tuple[str, ...]          # policy lowerings (or kernels) it covers
    kind: str                        # matmul | attention | decode | lif
    source: str | None               # csrc file, None for a plain lowering
    check: Callable[..., list[ContractFinding]]
    symbols: tuple[str, ...] = ()    # its __global__ functions, for ptxas


def _source(name: str) -> str:
    from repro_torch.kernels import _build

    return (_build.CSRC / name).read_text()


def _export(lib, fn: str, *args, n: int = 5) -> tuple | None:
    """``fn(*args, out)`` of the library into ``n`` long longs, or None where
    the library lacks it."""
    f = getattr(lib, fn, None)
    if f is None:
        return None
    buf = (ctypes.c_longlong * n)()
    if f(*args, ctypes.addressof(buf)) != 0:
        return None
    return tuple(buf)


# ----------------------------------------------------------- fused kernels --
_FUSED_BM, _FUSED_BN = 32, 128          # csrc/phi_fused.cu: BM, SBN


def _fused_covers(case: MatmulCase, src: str) -> list[Cover]:
    return [Cover("M", case.M, cdiv(case.M, _FUSED_BM), _FUSED_BM, "if (row >= M) continue;"),
            Cover("N", case.N, cdiv(case.N, _FUSED_BN), _FUSED_BN,
                  "const int valid = min(SCOLS, N - n);")]


def _fused_common(kernel: str, case: MatmulCase, bm: int, lib) -> list[ContractFinding]:
    src = _source("phi_fused.cu")
    out = check_coverage(kernel, case.name, _fused_covers(case, src), src)
    # l2_nnz: one int32 count per bm rows, at most every entry of the block's rows
    out += check_counter(kernel, case.name, "l2_nnz", bm * case.K, "int32")
    if lib is not None:
        real = _export(lib, "phi_fused_grid", case.M, case.N, n=4)
        out += check_plan(kernel, case.name,
                          (cdiv(case.M, _FUSED_BM), cdiv(case.N, _FUSED_BN), _FUSED_BM,
                           _FUSED_BN), real or ())
    return out


def _check_fused(case: MatmulCase, lib=None) -> list[ContractFinding]:
    from repro_torch.kernels import ops, phi_fused

    bm, _ = ops.autotune_fused_blocks(case.M, case.K, case.N, case.q, case.T)
    out = _fused_common("phi_fused", case, bm, lib)
    model = phi_fused.fused_smem_bytes(case.T)
    admitted = ops.fused_shape_viable(case.M, case.K, case.N, case.T, case.q) == "fused"
    real = None if lib is None else int(lib.phi_fused_smem_bytes(case.T))
    return out + check_smem("phi_fused", case.name, model, phi_fused.SMEM_LIMIT, admitted,
                            real)


def _check_fused_stream(case: MatmulCase, lib=None) -> list[ContractFinding]:
    from repro_torch.kernels import ops, phi_fused

    bm, _, _ = ops.autotune_stream_blocks(case.M, case.K, case.N, case.q, case.T)
    out = _fused_common("phi_fused_stream", case, bm, lib)
    gt = ops.stream_group_t(case.q, case.k)
    if gt is None:
        return out
    model = phi_fused.stream_smem_bytes(case.q, case.k, gt)
    real = None if lib is None else int(lib.phi_fused_stream_smem_bytes(case.q, case.k, gt))
    return out + check_smem("phi_fused_stream", case.name, model, phi_fused.SMEM_LIMIT, True,
                            real)


def _check_fused_prefetch(case: MatmulCase, lib=None) -> list[ContractFinding]:
    from repro_torch.kernels import ops, phi_fused

    bm, _ = ops.autotune_prefetch_blocks(case.M, case.K, case.N, case.q, case.T,
                                         PREFETCH_P_ACTIVE)
    out = _fused_common("phi_fused_prefetch", case, bm, lib)
    model = phi_fused.fused_smem_bytes(case.T)
    admitted = ops.fused_shape_viable(case.M, case.K, case.N, case.T, case.q,
                                      p_active=PREFETCH_P_ACTIVE) == "fused_prefetch"
    real = None if lib is None else int(lib.phi_fused_smem_bytes(case.T))
    return out + check_smem("phi_fused_prefetch", case.name, model, phi_fused.SMEM_LIMIT,
                            admitted, real)


# -------------------------------------------------- the per-unit kernels ---
_GATHER_ROWS = 8                        # csrc/phi_gather.cu: ROWS
_SPMM_WARPS = 8                         # csrc/phi_spmm.cu: WARPS
_UNIT_BLOCK_M = 256                     # ops.l1_gather / ops.l2_spmm default block_m


def _check_pallas(case: MatmulCase, lib=None) -> list[ContractFinding]:
    from repro_torch.kernels import matcher, ops
    from repro_torch.kernels.phi_spmm import SPMM_SLICE, spmm_rows_per_warp

    out: list[ContractFinding] = []
    # matcher: 64 rows x tp partitions a block
    tp, chunk, smem = matcher.matcher_plan(case.T, case.q, case.k)
    src = _source("matcher.cu")
    covers = [Cover("M", case.M, cdiv(case.M, matcher.MATCHER_ROWS), matcher.MATCHER_ROWS,
                    "if (m >= M) continue;"),
              Cover("T", case.T, cdiv(case.T, tp), tp, "const int tn = min(tp, T - t0);")]
    out += check_coverage("matcher", case.name, covers, src)
    real = None if lib is None else _export(lib, "matcher_grid", case.M, case.T, case.q,
                                            case.k, n=5)
    if lib is not None:
        out += check_plan("matcher", case.name,
                          (cdiv(case.M, matcher.MATCHER_ROWS) * cdiv(case.T, tp),
                           matcher.MATCHER_ROWS, tp, chunk, smem), real or ())
    out += check_smem("matcher", case.name, smem, matcher.MATCHER_SMEM_BUDGET, True,
                      None if real is None else real[4])
    # gather: ROWS rows x 128 (vector) or 32 columns a block
    vec = case.N % 4 == 0
    cols = 128 if vec else 32
    src = _source("phi_gather.cu")
    out += check_coverage("l1_gather", case.name, [
        Cover("M", case.M, cdiv(case.M, _GATHER_ROWS), _GATHER_ROWS,
              "if (m >= M || c >= N) return;"),
        Cover("N", case.N, cdiv(case.N, cols), cols, "if (m >= M || c >= N) return;")], src)
    if lib is not None:
        out += check_plan("l1_gather", case.name,
                          (cdiv(case.M, _GATHER_ROWS), cdiv(case.N, cols), _GATHER_ROWS, cols),
                          _export(lib, "l1_gather_grid", case.M, case.N, int(vec), n=4) or ())
    # spmm: G blocks of bm rows, rpw rows a warp, 8 warps a block, 128 columns
    bm = ops.effective_block_m(case.M, _UNIT_BLOCK_M)
    G = cdiv(case.M, bm)
    rpw = spmm_rows_per_warp(G, bm, case.N)
    warps = G * cdiv(bm, rpw)
    src = _source("phi_spmm.cu")
    out += check_coverage("l2_spmm", case.name, [
        Cover("rows", G * bm, cdiv(warps, _SPMM_WARPS), _SPMM_WARPS * rpw,
              "if (wid >= static_cast<long long>(G) * groups) return;"),
        Cover("rows_of_a_block", bm, cdiv(bm, rpw), rpw, "const int r1 = min(bm, r0 + rpw);"),
        Cover("N", case.N, cdiv(case.N, SPMM_SLICE), SPMM_SLICE, "if (c < N)")], src)
    if lib is not None:
        out += check_plan("l2_spmm", case.name,
                          (cdiv(warps, _SPMM_WARPS), cdiv(case.N, SPMM_SLICE), _SPMM_WARPS,
                           SPMM_SLICE), _export(lib, "l2_spmm_grid", G, bm, case.N, rpw, n=4)
                          or ())
    return out


# ------------------------------------------------------ plain lowerings ---
def _plain_matmul(impl: str) -> Callable[..., list[ContractFinding]]:
    def check(case: MatmulCase, lib=None) -> list[ContractFinding]:
        import torch

        from repro_torch.kernels import ops

        g = torch.Generator().manual_seed(0)
        a = (torch.rand((case.M, case.K), generator=g) < 0.3).float()
        pats = (torch.rand((case.T, case.q, case.k), generator=g) < 0.3).to(torch.uint8)
        w = torch.randn((case.K, case.N), generator=g)
        from repro_torch.core.patterns import pattern_weight_products

        pwp = pattern_weight_products(pats, w)
        out = ops.phi_matmul(a, w, pats, pwp, impl=impl)
        return check_shape(impl, case.name, tuple(out.shape), (case.M, case.N))
    return check


# ------------------------------------------------------------ attention ---
def _attn_common(kernel: str, case: AttnCase, T: int, lib) -> list[ContractFinding]:
    from repro_torch.kernels import ops, phi_attention

    bq, bkv = ops.autotune_attn_blocks(case.S, case.D, T, case.qp, case.kp)
    bq, bkv = min(bq, case.S), min(bkv, case.S)
    nq = cdiv(case.S, bq)
    src = _source("phi_attention.cu")
    out = check_coverage(kernel, case.name, [
        Cover("S", case.S, nq, bq, "if (r < bq && sr < S) {"),
        Cover("S_kv", case.S, cdiv(case.S, bkv), bkv, "if (sr < S)")], src)
    model = phi_attention.smem_bytes(bq, bkv, case.D, T, case.qp)
    admitted = ops.attn_shape_viable(case.S, case.D, T, case.qp, case.kp)
    real = None
    if lib is not None:
        real = int(lib.phi_attention_smem_bytes(bq, bkv, case.D, T, case.qp, int(T > 0)))
        out += check_plan(kernel, case.name, (case.B * case.H * nq, nq),
                          _export(lib, "phi_attention_grid", case.B, case.S, case.H, bq, n=2)
                          or ())
    return out + check_smem(kernel, case.name, model, phi_attention.SMEM_LIMIT, admitted, real)


def _check_phi_flash(case: AttnCase, lib=None) -> list[ContractFinding]:
    out = _attn_common("phi_flash_attention", case, case.T, lib)
    # l2_nnz (B*H, nq) int32: every K row's residual over all of D, at most S*D
    return out + check_counter("phi_flash_attention", case.name, "l2_nnz", case.S * case.D,
                               "int32")


def _check_flash(case: AttnCase, lib=None) -> list[ContractFinding]:
    import torch

    from repro_torch.models.flash import _flash_fwd_impl

    out = _attn_common("flash_attention", case, 0, lib)
    q = torch.zeros((case.B, case.S, case.H, case.D))
    o, lse = _flash_fwd_impl(q, q, q, True, None, None, 64, 64)   # pad-and-mask tails
    out += check_shape("flash_plain", case.name, tuple(o.shape), tuple(q.shape))
    return out + check_shape("flash_plain", case.name + ":lse", tuple(lse.shape),
                             (case.B, case.H, case.S))


# --------------------------------------------------------------- decode ---
def _check_decode(case: DecodeCase, lib=None) -> list[ContractFinding]:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.phi_fused import SMEM_LIMIT

    p = da.plan(case.Smax, case.D)
    src = _source("decode_attention.cu")
    out = check_coverage("decode_attention", case.name, [
        Cover("Smax", case.Smax, p["chunks"], p["chunk"],
              "const int rows = min(CHUNK, Smax - c0);"),
        Cover("D", case.D, 1, p["threads"], "for (int d = tid; d < D; d += THREADS)",
              stride=True)], src)
    real = None
    if lib is not None:
        got = _export(lib, "decode_attention_plan", case.Smax, case.D, n=5)
        want = (p["chunk"], p["threads"], p["chunks"], p["smem_bytes"], p["ws_floats"])
        out += check_plan("decode_attention", case.name, want, got or ())
        real = None if got is None else got[3]
    return out + check_smem("decode_attention", case.name, p["smem_bytes"], SMEM_LIMIT,
                            case.D <= da.MAX_D, real)


# ------------------------------------------------------------------ LIF ---
_LIF_THREADS, _LIF_MAX_BLOCKS = 256, 132 * 16     # csrc/lif.cu: THREADS, MAX_BLOCKS


def _check_lif(case: LifCase, lib=None) -> list[ContractFinding]:
    blocks = min(cdiv(case.n, _LIF_THREADS), _LIF_MAX_BLOCKS)
    src = _source("lif.cu")
    out = check_coverage("lif_sequence", case.name, [
        Cover("n", case.n, blocks, _LIF_THREADS, "threadIdx.x; i < n;",
              stride=blocks * _LIF_THREADS < case.n)], src)
    if lib is not None:
        out += check_plan("lif_sequence", case.name, (blocks, _LIF_THREADS),
                          _export(lib, "lif_grid", case.n, n=2) or ())
    return out


CONTRACTS: tuple[KernelContract, ...] = (
    KernelContract("phi_fused", ("fused",), "matmul", "phi_fused.cu", _check_fused,
                   ("phi_fused_kernel",)),
    KernelContract("phi_fused_stream", ("fused_stream",), "matmul", "phi_fused.cu",
                   _check_fused_stream, ("phi_fused_stream_kernel",)),
    KernelContract("phi_fused_prefetch", ("fused_prefetch",), "matmul", "phi_fused.cu",
                   _check_fused_prefetch, ("phi_fused_kernel",)),
    KernelContract("pallas", ("pallas",), "matmul", None, _check_pallas,
                   ("matcher_kernel", "l1_gather_kernel", "l2_spmm_kernel")),
    KernelContract("coo", ("coo",), "matmul", None, _plain_matmul("coo")),
    KernelContract("ref", ("ref",), "matmul", None, _plain_matmul("ref")),
    KernelContract("phi_flash_attention", ("phi_flash",), "attention", "phi_attention.cu",
                   _check_phi_flash, ("attn_kernel",)),
    KernelContract("flash_attention", ("flash",), "attention", "phi_attention.cu",
                   _check_flash),
    KernelContract("decode_attention", ("decode",), "decode", "decode_attention.cu",
                   _check_decode, ("decode_partial_kernel", "decode_combine_kernel")),
    KernelContract("lif_sequence", ("lif",), "lif", "lif.cu", _check_lif,
                   ("lif_sequence_kernel", "lif_step_kernel")),
)
# Kernels outside the policy's lowerings that the registry must still cover.
EXTRA_KERNELS = ("lif", "decode")
_CASES = {"matmul": MATMUL_CASES, "attention": ATTN_CASES, "decode": DECODE_CASES,
          "lif": LIF_CASES}


def _assert_complete() -> None:
    """Import-time gate: every lowering the policy can resolve, and every
    kernel outside it, has a contract entry."""
    from repro_torch.kernels import ATTN_IMPLS, IMPLS

    covered = {c for entry in CONTRACTS for c in entry.covers}
    missing = (set(IMPLS) | set(ATTN_IMPLS) | set(EXTRA_KERNELS)) - covered
    if missing:
        raise AssertionError(
            f"lowerings {sorted(missing)} have no contract entry in "
            "repro_torch.analysis.registry: add a KernelContract (and shape-matrix "
            "coverage) before registering a new lowering")


_assert_complete()


def run_contracts(names: tuple[str, ...] | None = None, lib=None,
                  ptxas: list[str] | None = None) -> list[ContractFinding]:
    """Check every entry (or those ``names``) over its shape matrix; with the
    built library ``lib``, also against its exports, and with ptxas's lines,
    each kernel's spills."""
    findings: list[ContractFinding] = []
    spills = ptxas_spills(ptxas) if ptxas is not None else {}
    for entry in CONTRACTS:
        if names is not None and entry.name not in names:
            continue
        for case in _CASES[entry.kind]:
            findings.extend(entry.check(case, lib))
        if ptxas is not None and entry.symbols:
            findings.extend(check_spills(entry.name, entry.symbols, spills))
    return findings
