"""Host work while the card is drained, % of the window: over every
``serve.tick``, the tick less its ``serve.decode_step`` and ``serve.prefill``
children (each ends in a copy that waits for the card)."""
from phibench.metrics import _spans


def read(run):
    found = _spans.spans(run, "serve.tick", "serve.decode_step", "serve.prefill")
    ticks = {s["id"]: _spans.ms(s) for s in found or () if s["name"] == "serve.tick"}
    if not ticks or run.window_s <= 0:
        return None
    card = sum(_spans.ms(s) for s in found if s["parent"] in ticks)
    return 100.0 * (sum(ticks.values()) - card) / (run.window_s * 1e3)
