"""Milliseconds of a D step (``d_step``), the mean of the benchmark's
synchronized host spans around each call in the window."""


def read(run):
    spans = run.spans.get("d_step")
    if not spans:
        return None
    return 1e3 * sum(s for s, _ in spans) / len(spans)
