"""The program's own spans of a traced window, for the per-layer readers
that read them: ``repro_torch.obs.trace.profiled_spans()``, the spans the
program recorded while the harness's profiler ran, on the profiler's clock
(Unix nanoseconds). A run without a traced window, or a program that keeps
no such record, gives None."""
from __future__ import annotations


def spans(run, *names: str) -> list[dict] | None:
    """The window's spans named one of ``names``, in the order they closed;
    None where there is no traced window or none of them."""
    if run.summary is None:
        return None
    try:
        from repro_torch.obs import trace
    except ImportError:
        return None
    record = getattr(trace, "profiled_spans", None)
    found = [s for s in record() if s["name"] in names] if record else []
    return found or None


def ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6


def first_at(found: list[dict] | None, name: str) -> dict[int, int]:
    """Each request's first ``name`` event: rid -> its time, ns."""
    out: dict[int, int] = {}
    for s in found or ():
        if s["name"] == name:
            out.setdefault(s["rid"], s["start_ns"])
    return out


def in_quiet_ticks(run, name: str) -> list[float]:
    """Durations (ms) of the window's ``name`` spans inside the ticks that
    admit nothing, so that a tick's parts are read over the same ticks as
    the tick itself."""
    found = spans(run, "serve.tick", name) or ()
    quiet = {s["id"] for s in found if s["name"] == "serve.tick" and s["admitted"] == 0}
    return [ms(s) for s in found if s["name"] == name and s["parent"] in quiet]
