"""LIF neuron update: the Hopper kernel and its plain version.

Port of ``repro/kernels/lif.py::lif_pallas`` (one step: integrate, fire,
reset) plus the time loop of ``repro/snn/lif.py::lif_sequence`` as a second
kernel entry that keeps the membrane potential in a register across T. The
CUDA source is ``csrc/lif.cu``.

Each wrapper chooses by the device of its tensors: CPU tensors run the plain
version (``ref.lif_ref``, in a loop for the sequence); CUDA tensors launch
the kernel, counted in the wrapper's ``.launches``, or raise. A fake tensor
(a dry run's trace) skips the launch and its count, and logs its cost
(``kernels.costs``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels.ref import lif_ref

_RESETS = ("hard", "soft")


def _check(reset: str, *tensors: torch.Tensor) -> None:
    if reset not in _RESETS:
        raise ValueError(f"reset {reset!r} not in {_RESETS}")
    for x in tensors:
        if x.device.type != "cuda":
            raise ValueError(f"LIF kernel: tensor on {x.device}, expected cuda")
        if x.dtype != torch.float32:
            raise TypeError(f"LIF kernel takes float32, got {x.dtype}")


def lif_step_cuda(v: torch.Tensor, x: torch.Tensor, *, decay: float = 0.5,
                  threshold: float = 1.0, reset: str = "hard"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One LIF step on same-shape float32 tensors. Returns (spike, v')."""
    if v.device.type == "cpu":
        return lif_ref(v, x, decay, threshold, reset)
    _check(reset, v, x)
    if v.shape != x.shape or v.device != x.device:
        raise ValueError(f"v {tuple(v.shape)} on {v.device} vs x {tuple(x.shape)} on {x.device}")
    v, x = v.contiguous(), x.contiguous()
    spike, v_out = torch.empty_like(v), torch.empty_like(v)
    if v.numel() == 0:
        return spike, v_out
    if costs.traced(v):
        costs.record("lif_step_cuda", (v, x), costs.lif_step(v.numel()))
        return spike, v_out
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = _build.library().lif_step_launch(
            v.data_ptr(), x.data_ptr(), spike.data_ptr(), v_out.data_ptr(), v.numel(),
            decay, threshold, int(reset == "soft"), stream)
    _build.check(err, "lif_step_launch")
    lif_step_cuda.launches += 1
    return spike, v_out


lif_step_cuda.launches = 0


def lif_sequence_plain(x_seq: torch.Tensor, *, decay: float = 0.5, threshold: float = 1.0,
                       reset: str = "hard") -> torch.Tensor:
    """Plain version of the sequence kernel: a loop of LIF steps over axis 0."""
    v = torch.zeros_like(x_seq[0])
    spikes = []
    for x in x_seq:
        s, v = lif_ref(v, x, decay, threshold, reset)
        spikes.append(s)
    return torch.stack(spikes)


def lif_sequence_cuda(x_seq: torch.Tensor, *, decay: float = 0.5, threshold: float = 1.0,
                      reset: str = "hard") -> torch.Tensor:
    """LIF over a leading time axis from v = 0: (T, ...) currents -> (T, ...) spikes."""
    if x_seq.device.type == "cpu":
        return lif_sequence_plain(x_seq, decay=decay, threshold=threshold, reset=reset)
    _check(reset, x_seq)
    x_seq = x_seq.contiguous()
    spikes = torch.empty_like(x_seq)
    T = x_seq.shape[0]
    n = x_seq.numel() // T if T else 0
    if n == 0:
        return spikes
    if costs.traced(x_seq):
        costs.record("lif_sequence_cuda", (x_seq,), costs.lif_sequence(T, n))
        return spikes
    with torch.cuda.device(x_seq.device):
        stream = torch.cuda.current_stream(x_seq.device).cuda_stream
        err = _build.library().lif_sequence_launch(
            x_seq.data_ptr(), spikes.data_ptr(), T, n, decay, threshold,
            int(reset == "soft"), stream)
    _build.check(err, "lif_sequence_launch")
    lif_sequence_cuda.launches += 1
    return spikes


lif_sequence_cuda.launches = 0
