"""Plain spiking arithmetic shared by the references: LIF rate coding and the
spiking GEMM, in float32 (TF32 off) or in a named lower precision.

Nothing here imports the program. The LIF neuron is the one the paper and
the configurations state: v <- decay * v + x, a spike where v >= threshold,
then a hard reset to zero.
"""
from __future__ import annotations

import contextlib

import torch

# Precisions a spiking GEMM can be computed in. "float32" is the stated one;
# the others are the controls: the nearest precision below it.
GEMM_PRECISIONS = ("float64", "float32", "tf32", "bfloat16")


@contextlib.contextmanager
def exact_float32():
    """TF32 off for every float32 matmul inside (restored on exit)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def lif_spikes(x_seq: torch.Tensor, decay: float, threshold: float,
               margin: torch.Tensor | None = None) -> torch.Tensor:
    """(T, B, ...) currents -> (T, B, ...) {0, 1} spikes, from v = 0, in the
    currents' dtype. ``margin`` (B,), where given, is lowered to the least
    distance of any membrane potential of row b from the threshold."""
    v = torch.zeros_like(x_seq[0])
    out = []
    for x in x_seq:
        v = v * decay + x
        if margin is not None:
            dist = (v - threshold).abs().reshape(v.shape[0], -1).amin(-1)
            torch.minimum(margin, dist.to(margin.dtype), out=margin)
        s = (v >= threshold).to(v.dtype)
        v = v * (1.0 - s)
        out.append(s)
    return torch.stack(out)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10-bit mantissa (round to nearest, ties to
    even), as the tensor cores read an operand: the TF32 control on any
    device."""
    bits = x.contiguous().view(torch.int32)
    low = bits & 0x1FFF
    keep = bits & ~0x1FFF
    half = 0x1000
    odd = (bits >> 13) & 1
    up = (low > half) | ((low == half) & (odd == 1))
    return (keep + up.to(torch.int32) * 0x2000).view(torch.float32)


def matmul(a: torch.Tensor, w: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """a @ w in float32 (TF32 off) or float64, or in a control precision: "tf32" rounds
    both operands to TF32 and sums in float32; "bfloat16" rounds both to
    bfloat16 and the product to bfloat16, as a bfloat16 GEMM returns it."""
    if precision == "float64":
        return a.to(torch.float64) @ w.to(torch.float64)
    if precision == "float32":
        return a.to(torch.float32) @ w.to(torch.float32)
    if precision == "tf32":
        return to_tf32(a.to(torch.float32)) @ to_tf32(w.to(torch.float32))
    if precision == "bfloat16":
        prod = a.to(torch.bfloat16).to(torch.float32) @ w.to(torch.bfloat16).to(torch.float32)
        return prod.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"precision {precision!r} not in {GEMM_PRECISIONS}")
