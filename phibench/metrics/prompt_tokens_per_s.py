"""True prompt tokens of the requests whose first token came in the window,
over the window."""


def read(run):
    n = run.records.get("prompt_tokens")
    return n / run.window_s if n else None
