"""Milliseconds of a G step (``g_step``), the mean of the benchmark's
synchronized host spans around each call in the window."""


def read(run):
    spans = run.spans.get("g_step")
    if not spans:
        return None
    return 1e3 * sum(s for s, _ in spans) / len(spans)
