"""Phi-sparse flash attention: the Hopper kernel and its plain version.

Port of ``repro/kernels/phi_attention.py``. A flash score block
``S = Qᵢ·Kⱼᵀ`` over binary spike K rows is itself a Phi matmul, with the K
rows as the activations and ``Qᵢᵀ`` as the weight: each K row decomposes
against the calibrated bank as ``pattern[idx] + residual``, so

    Sᵀ = K·Qᵢᵀ = onehot(idx)·(P·Qᵢᵀ)  +  residual·Qᵢᵀ
         └─ L1: gathered pattern×Q products ─┘  └─ L2: ±1 residual ─┘

One-hot selections and ±1 residual entries make every partial product
exact, so for binary Q/K the score blocks equal the dense ``q·kᵀ`` bitwise;
scale is applied after the contraction.

* :func:`phi_flash_attention_plain` — the plain PyTorch version: drives
  ``models.flash._flash_fwd_impl`` with the Phi ``score_fn``, so its
  online-softmax accumulator is the dense flash code and its output is
  bitwise equal to the port's dense ``flash_attention`` on the CPU.
* :func:`phi_flash_attention_cuda` — the kernel's wrapper
  (``csrc/phi_attention.cu``, whose note says how it is laid out on the
  card); :func:`flash_attention_cuda` launches the same kernel's dense
  instantiation, which also writes the per-row logsumexp where asked
  (``return_lse``: the forward of ``models.flash.flash_attention`` under
  autograd). CPU tensors run the plain versions; CUDA tensors launch the
  kernel, counted in the wrapper's ``.launches``, or raise. A fake tensor
  (a dry run's trace) skips the launch and its count, and logs its cost
  (``kernels.costs``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels.phi_fused import MAX_K, SMEM_LIMIT, _partition_body, pack_patterns
from repro_torch.models.flash import _flash_fwd_impl
from repro_torch.utils import cdiv


def smem_bytes(bq: int, bkv: int, D: int, T: int = 0, qp: int = 0) -> int:
    """Dynamic shared memory of one kernel block, in bytes (``T = 0``: dense).

    The layout of ``csrc/phi_attention.cu::make_layout``: for the Phi
    instantiation the packed bank (T·qp words), the matched pattern word and
    the residual ± masks of each K row and partition (3·bkv·T words) and the
    Q rows as bits (bq·T words), rounded up to 16 bytes; for both, the Q and
    K blocks with rows of an odd number of 16-byte words, the V block with
    rows rounded up to 8 floats, the score block with one padding column,
    the per-row rescale and one counter.
    """
    ld = 4 * (cdiv(D, 4) | 1)
    phi = -(-8 * T * (qp + 3 * bkv + bq) // 16) * 16
    return phi + 4 * (bq * ld + bkv * ld + bkv * cdiv(D, 8) * 8 + bq * (bkv + 1) + bq + 1)


def block_q_ok(bq: int, D: int) -> bool:
    """Whether the kernel takes ``bq`` query rows a block at head size D: at
    most 128 (two softmax rows per thread), covered by four passes of its
    p.V phase (256 threads, 8 columns each: 256 // ceil(D / 8) rows a pass)."""
    return bq <= 128 and bq <= 4 * (256 // cdiv(D, 8))


def launch_bound_blocks(bq: int, D: int) -> int:
    """Blocks an SM the kernel is built for at ``bq`` rows and head size D
    (its ``__launch_bounds__``): three where one p.V pass covers the block,
    else two. Registers hold it there whatever shared memory allows."""
    return 3 if bq <= 256 // cdiv(D, 8) else 2


# ------------------------------------------------------------ score block ---
def attn_score_block(kt: torch.Tensor, qi: torch.Tensor, patterns: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Phi-decomposed score block ``sᵀ = K·Qᵢᵀ`` for one or many (batch, head).

    kt (..., bkv, D) binary K rows, qi (..., bq, D), patterns (T, qp, kp) with
    T·kp ≤ D (a dense ragged tail covers D − T·kp). Returns
    ``(s (..., bq, bkv) f32, l2_nnz (...) int32)``. Exact: every partial
    product is exact, so for binary inputs ``s`` equals the dense
    ``qi @ ktᵀ`` bitwise.
    """
    T, qp, kp = patterns.shape
    lead, bkv, D = kt.shape[:-2], kt.shape[-2], kt.shape[-1]
    bq = qi.shape[-2]
    kt = kt.to(torch.float32)
    qi = qi.to(torch.float32)
    pats = patterns.to(device=kt.device, dtype=torch.float32)
    acc1 = torch.zeros((*lead, bkv, bq), dtype=torch.float32, device=kt.device)
    acc2 = torch.zeros_like(acc1)
    nnz = torch.zeros(lead, dtype=torch.int32, device=kt.device)
    ones = torch.ones((qp + 1,), dtype=torch.float32, device=kt.device)
    zero_row = torch.zeros((*lead, 1, bq), dtype=torch.float32, device=kt.device)
    for t in range(T):
        p = pats[t]
        q_t = qi[..., t * kp:(t + 1) * kp]
        # the attention "PWP": pattern × Qᵀ products, built once per q-block
        pwp_t = torch.cat([p @ q_t.mT, zero_row], dim=-2)          # (..., qp+1, bq)
        acc1, acc2, cnt = _partition_body(kt[..., t * kp:(t + 1) * kp], p, pwp_t, ones,
                                          q_t.mT, acc1, acc2, q=qp)
        nnz = nnz + cnt.sum(-1, dtype=torch.int32)
    s = acc1 + acc2                                                # (..., bkv, bq)
    used = T * kp
    if used < D:                                                   # dense ragged tail
        s = s + kt[..., used:] @ qi[..., used:].mT
    return s.mT, nnz


# ---------------------------------------------------------- plain version ---
def phi_flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              patterns: torch.Tensor, *, causal: bool = False,
                              window: int | None = None, chunk: int | None = None,
                              block_q: int = 128, block_kv: int = 128
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain Phi flash attention. q/k/v (B, S, H, D), binary spike Q/K.

    Port of the reference's ``phi_flash_attention_xla``: the dense flash
    accumulator with the Phi score blocks, so the output is bitwise equal to
    ``flash_attention`` with the same blocks. Also returns the kernel's
    audit counter, ``l2_nnz`` (B·H, nq) int32: the residual entries of all
    K rows, the same in every q-block column.
    """
    B, S, H, _ = q.shape
    nnz_blocks: list[torch.Tensor] = []

    def score_fn(qi, kj):                                          # (B, H, bq/bkv, D)
        s, nnz = attn_score_block(kj, qi, patterns)
        nnz_blocks.append(nnz)
        return s

    out, _ = _flash_fwd_impl(q, k, v, causal, window, chunk, block_q, block_kv,
                             score_fn=score_fn)
    nq = cdiv(S, min(block_q, S))
    # score_fn ran q-block-major: nq groups of nkv (B, H) counts.
    nnz = torch.stack(nnz_blocks).reshape(nq, -1, B, H).sum(1, dtype=torch.int32)
    return out, nnz.permute(1, 2, 0).reshape(B * H, nq)


# ----------------------------------------------------------------- kernel ---
def _check_operands(q, k, v, packed, patterns_shape) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q is on {q.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"attention kernel takes float32 q/k/v, got {name} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.ndim != 4 or x.shape != q.shape:
            raise ValueError(f"q, k, v must share one (B, S, H, D) shape; got {name} "
                             f"{tuple(x.shape)} against q {tuple(q.shape)}")
    if packed is None:
        return
    T, qp, kp = patterns_shape
    if kp > MAX_K or T * kp > q.shape[-1]:
        raise ValueError(f"attention kernel takes kp <= {MAX_K} and T*kp <= D; got T={T}, "
                         f"kp={kp}, D={q.shape[-1]}")
    if packed.device != q.device or packed.dtype != torch.int64 \
            or packed.shape != (T, qp) or not packed.is_contiguous():
        raise ValueError(f"packed must be a contiguous (T, qp) = ({T}, {qp}) int64 tensor on "
                         f"{q.device} from pack_patterns, got {tuple(packed.shape)} "
                         f"{packed.dtype} on {packed.device}")


def _launch(q, k, v, packed, patterns_shape, *, causal, window, chunk, block_q, block_kv,
            lse: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch one instantiation: Phi scores and ``l2_nnz`` when ``packed`` is
    given, else dense scores and, with ``lse``, the (B·H, S) float32
    logsumexp of each query row in place of the count."""
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel: unsupported device {q.device}")
    _check_operands(q, k, v, packed, patterns_shape)
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    B, S, H, D = q.shape
    T, qp, kp = patterns_shape if packed is not None else (0, 0, 0)
    bq, bkv = min(block_q, S), min(block_kv, S)
    need = smem_bytes(bq, bkv, D, T, qp)
    if need > SMEM_LIMIT:
        raise ValueError(f"attention kernel: blocks ({bq}, {bkv}) at D={D}, T={T}, qp={qp} "
                         f"need {need} B of shared memory, more than {SMEM_LIMIT}")
    if not block_q_ok(bq, D):
        raise ValueError(f"attention kernel: block_q={bq} at D={D} is more rows than a block "
                         "takes (at most 128, and 4 * (256 // ceil(D / 8)))")
    nq = cdiv(S, bq) if S else 0
    out = torch.empty_like(q)
    lse_out = torch.empty((B * H, S), dtype=torch.float32, device=q.device) if lse else None
    if out.numel() == 0:
        return out, lse_out if lse else torch.zeros((B * H, nq), dtype=torch.int32,
                                                     device=q.device)
    # Every block of the Phi instantiation writes its (batch·head, q-block) count.
    nnz = None if packed is None else torch.empty((B * H, nq), dtype=torch.int32,
                                                  device=q.device)
    if costs.traced(q):
        return out, lse_out if lse else nnz
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _build.library().phi_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if packed is None else packed.data_ptr(), out.data_ptr(),
            None if packed is None else nnz.data_ptr(),
            None if lse_out is None else lse_out.data_ptr(), B, S, H, D, T, qp, kp, bq, bkv,
            int(causal), int(window is not None), 0 if window is None else window,
            0 if chunk is None else chunk, ctypes.c_float(D ** -0.5), int(packed is not None),
            stream)
    _build.check(err, "phi_attention_launch")
    return out, lse_out if lse else nnz


def phi_flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             patterns: torch.Tensor, *, packed: torch.Tensor | None = None,
                             causal: bool = False, window: int | None = None,
                             chunk: int | None = None, block_q: int = 128,
                             block_kv: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Phi flash attention. q/k/v (B, S, H, D) f32 with binary spike Q/K.

    patterns (T, qp, kp), T·kp ≤ D, kp ≤ 64. Returns ``(out (B, S, H, D) f32,
    l2_nnz (B·H, nq) int32)``. CPU tensors run the plain version; CUDA
    tensors launch the kernel, counted in ``.launches``, which reads the bank
    as ``packed`` (:func:`pack_patterns` of ``patterns``; packed here when the
    caller has not).
    """
    if q.device.type == "cpu":
        return phi_flash_attention_plain(q, k, v, patterns, causal=causal, window=window,
                                         chunk=chunk, block_q=block_q, block_kv=block_kv)
    packed = pack_patterns(patterns) if packed is None else packed
    out, nnz = _launch(q, k, v, packed, tuple(patterns.shape), causal=causal, window=window,
                       chunk=chunk, block_q=block_q, block_kv=block_kv)
    if not costs.traced(q):
        phi_flash_attention_cuda.launches += 1
    elif out.numel():
        B, S, H, D = q.shape
        T, qp, kp = patterns.shape
        nq = cdiv(S, min(block_q, S))
        costs.record("phi_flash_attention_cuda", (q, k, v, patterns), costs.phi_attention(
            B, S, H, D, T, qp, kp, nq, int(costs.DRY_RUN_L2_DENSITY * B * H * S * T * kp)))
    return out, nnz


phi_flash_attention_cuda.launches = 0


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         chunk: int | None = None, block_q: int = 512,
                         block_kv: int = 1024, return_lse: bool = False
                         ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Dense flash attention through the kernel's dense instantiation.

    Same contract as ``models.flash.flash_attention`` (float32 q/k/v on the
    card). With ``return_lse`` it returns ``(out, lse)``, lse (B, H, S)
    float32 = m + log(max(den, 1e-30)) per query row, as ``_flash_fwd_impl``
    gives it. CPU tensors run ``_flash_fwd_impl``; CUDA tensors launch the
    kernel, counted in ``.launches`` (and in ``.lse_launches`` when it writes
    lse), or raise.
    """
    if q.device.type == "cpu":
        out, lse = _flash_fwd_impl(q, k, v, causal, window, chunk, block_q, block_kv)
        return (out, lse) if return_lse else out
    out, lse = _launch(q, k, v, None, None, causal=causal, window=window, chunk=chunk,
                       block_q=block_q, block_kv=block_kv, lse=return_lse)
    traced = costs.traced(q)
    if not traced:
        flash_attention_cuda.launches += 1
    elif out.numel():
        costs.record("flash_attention_cuda", (q, k, v),
                     costs.dense_attention(*q.shape, causal, window, chunk))
    if not return_lse:
        return out
    flash_attention_cuda.lse_launches += int(not traced)
    B, S, H, _ = q.shape
    return out, lse.view(B, H, S)


flash_attention_cuda.launches = 0
flash_attention_cuda.lse_launches = 0
