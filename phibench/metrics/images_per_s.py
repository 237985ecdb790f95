"""Images classified over the whole window, per second."""


def read(run):
    n = run.records.get("images")
    return n / run.window_s if n else None
