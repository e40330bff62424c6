"""Output tokens per second: every token the window's prefills and decode
steps served, over the window's seconds (whole batches only)."""


def read(run):
    return run.tokens / run.window_s
