"""Every token generated in the window, over the window."""


def read(run):
    n = run.records.get("output_tokens")
    return n / run.window_s if n else None
