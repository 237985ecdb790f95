"""One-token decode attention: the Hopper kernel and its plain version.

The reference's ``attention_decode`` (``repro/models/layers.py``) is plain
JAX, with no Pallas kernel. The port's plain version,
:func:`decode_attention_plain`, is that function in PyTorch; its einsums sum
in an order that depends on the batch and head counts. The kernel
(``csrc/decode_attention.cu``, whose note says how it is laid out) fixes
every sum's order from the cache length and the head size alone, so each
(row, head) of its output has the same bits whatever the batch, the head
count and the grid: a rank of a mesh runs its own rows and heads and gets
one device's bits.

:func:`decode_attention_cuda` runs the plain version for CPU tensors; CUDA
tensors launch the kernel, counted in its ``.launches``, or raise. A fake
tensor (a dry run's trace) skips the launch and its count, and logs its cost
(``kernels.costs``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, costs
from repro_torch.models.layers import _repeat_kv

MODES = ("full", "ring", "chunk_ring")
# Keys a pass-1 block takes, threads a block and the largest head size:
# csrc/decode_attention.cu's CHUNK, THREADS and MAX_D.
CHUNK = 64
THREADS = 128
MAX_D = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def valid_keys(pos: torch.Tensor, smax: int, mode: str) -> torch.Tensor:
    """(B, Smax) bool: the cache slots each row's query attends to.

    "full": slot == position, valid kpos <= pos; "ring": a ring of size
    Smax == window, every filled slot in window; "chunk_ring": slot s holds
    the latest position ≡ s (mod chunk), the current chunk's slots are
    s <= pos mod chunk."""
    kpos = torch.arange(smax, device=pos.device)[None, :]
    p_ = pos[:, None]
    if mode == "full":
        return kpos <= p_
    if mode == "ring":
        return (kpos <= p_) | (p_ >= smax)
    if mode == "chunk_ring":
        return kpos <= (p_ % smax)
    raise ValueError(mode)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           pos: torch.Tensor, *, mode: str = "full") -> torch.Tensor:
    """Plain decode attention. q (B,1,Hq,D); caches (B,Smax,Hkv,D); pos (B,) int."""
    rep = q.shape[2] // k_cache.shape[2]
    k = _repeat_kv(k_cache, rep)
    v = _repeat_kv(v_cache, rep)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
    valid = valid_keys(pos, k.shape[1], mode)
    s = torch.where(valid[:, None, None, :], s, -torch.inf)
    p = torch.softmax(s, -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32)).to(q.dtype)


def plan(smax: int, D: int) -> dict:
    """The kernel's launch plan for one (row, head) at cache length ``smax``
    and head size D, as ``decode_attention_plan`` exports it: keys a pass-1
    block, threads a block, pass-1 blocks, the pass-1 block's dynamic shared
    memory (q, the K chunk at row stride D + 1, p; float32) and workspace
    floats ((m, l, acc[D]) a chunk)."""
    chunks = -(-smax // CHUNK)
    return {"chunk": CHUNK, "threads": THREADS, "chunks": chunks,
            "smem_bytes": 4 * (D + CHUNK * (D + 1) + CHUNK), "ws_floats": chunks * (D + 2)}


def _check(q, k_cache, v_cache, pos, mode) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache), ("pos", pos)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q is on {q.device}")
    if q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"q (B, 1, Hq, D) and caches (B, Smax, Hkv, D); got q "
                         f"{tuple(q.shape)}, caches {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)}")
    B, _, Hq, D = q.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != D or Hq % k_cache.shape[2] \
            or pos.shape != (B,):
        raise ValueError(f"q {tuple(q.shape)}, caches {tuple(k_cache.shape)} and pos "
                         f"{tuple(pos.shape)} disagree")
    if q.dtype not in _DTYPES or k_cache.dtype not in _DTYPES \
            or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"decode kernel takes float32 or bfloat16 q and caches of one of "
                        f"those; got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode kernel reads the caches in place: they must be contiguous")
    if D > MAX_D:
        raise ValueError(f"decode kernel takes head size <= {MAX_D}, got {D}")


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          pos: torch.Tensor, *, mode: str = "full") -> torch.Tensor:
    """Decode attention: (B,1,Hq,D) in q's dtype. CPU tensors run
    :func:`decode_attention_plain`; CUDA tensors launch the kernel, counted
    in ``.launches``: the caches are read in place, Q head h reading KV head
    h // (Hq / Hkv)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos, mode=mode)
    if q.device.type != "cuda":
        raise ValueError(f"decode kernel: unsupported device {q.device}")
    _check(q, k_cache, v_cache, pos, mode)
    B, _, Hq, D = q.shape
    smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    pl = plan(smax, D)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ws = torch.empty(B * Hq * pl["ws_floats"], dtype=torch.float32, device=q.device)
    if costs.traced(q):
        # a traced pos holds no values: every cache row is counted, the rows a
        # step over a full cache keeps (the dry run's decode at its context)
        costs.record("decode_attention_cuda", (q, k_cache, v_cache),
                     costs.decode_attention(B, Hq, Hkv, D, B * smax, q.element_size(),
                                            k_cache.element_size()))
        return out
    qc = q.contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _build.library().decode_attention_launch(
            qc.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos32.data_ptr(),
            out.data_ptr(), ws.data_ptr(), B, smax, Hq, Hkv, D, MODES.index(mode),
            _DTYPES[q.dtype], _DTYPES[k_cache.dtype], ctypes.c_float(D ** -0.5), stream)
    _build.check(err, "decode_attention_launch")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
