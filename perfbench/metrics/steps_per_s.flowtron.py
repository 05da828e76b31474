"""Flowtron training steps a second: every step the traced window completed
over all its seconds (the traced steps each run inside the program's
``tracing()``, a CUDA event pair a span)."""


def read(run):
    if not run.count.get("steps"):
        return None
    return run.count["steps"] / run.window_s
