"""Reduction of one ``torch.profiler`` window to the numbers the run reports.

The window is the host range recorded as ``phibench.window``. Every device
event inside it (kernels, copies, sets) is clipped to it; their union is the
busy time, and what it leaves of the window are the idle gaps. Each gap is
named by what the host was doing at its middle: the innermost host event
there, under the innermost of the harness's own ``phibench.*`` ranges.
"""
from __future__ import annotations

import dataclasses

import numpy as np

WINDOW = "phibench.window"
TOP = 10
NAME_CHARS = 160          # a kernel's name in the breakdown, cut to this length


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_s_by_name: dict[str, float]
    breakdown: dict

    def device_s(self, names: list[str]) -> float:
        """Device seconds of the events whose name holds one of ``names``."""
        return sum(s for n, s in self.device_s_by_name.items() if any(k in n for k in names))


def _span(ev) -> tuple[int, int]:
    if hasattr(ev, "start_ns"):
        start = ev.start_ns()
        return start, start + ev.duration_ns()
    start = ev.start_us() * 1000
    return start, start + ev.duration_us() * 1000


def summarize(prof) -> Summary:
    """The window's busy and idle time, device time by name and breakdown."""
    from torch.autograd import DeviceType

    host, dev = [], []
    for ev in prof.profiler.kineto_results.events():
        start, end = _span(ev)
        (dev if ev.device_type() != DeviceType.CPU else host).append((start, end, ev.name()))
    windows = [(s, e) for s, e, n in host if n == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} ranges named {WINDOW}")
    w0, w1 = windows[0]
    by_name: dict[str, float] = {}
    spans = []
    for s, e, n in dev:
        if n.startswith("phibench."):       # the window's own range, mirrored on the device
            continue
        s, e = max(s, w0), min(e, w1)
        if e > s:
            spans.append((s, e))
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    spans.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, w0
    for s, e in spans:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((w1 - cur_e, cur_e, w1))
    gaps.sort(reverse=True)
    hs = np.array([h[0] for h in host], dtype=np.int64)
    he = np.array([h[1] for h in host], dtype=np.int64)
    names = [h[2] for h in host]
    idle = []
    for length, s, e in gaps[:TOP]:
        mid = (s + e) // 2
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        inner = [i for i in inside if names[i] != WINDOW]
        ours = [i for i in inner if names[i].startswith("phibench.")]
        label = names[max(inner, key=lambda i: hs[i])] if inner else "host outside any op"
        if ours:
            outer = names[max(ours, key=lambda i: hs[i])]
            label = outer if outer == label else f"{outer} > {label}"
        idle.append([label, length / 1e9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, device_s_by_name=by_name,
                   breakdown={"device_ops": [[n[:NAME_CHARS], s] for n, s in top],
                              "idle_gaps": [[n[:NAME_CHARS], s] for n, s in idle]})
