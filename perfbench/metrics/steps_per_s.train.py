"""G and D steps of the global batch a second (3 a G/G/D cycle): every
step the window completed over all its seconds. A per-layer metric: on
the shared host its runs spread too widely for an end-to-end bound
(PERF.md), and in a traced run the host spans synchronize at each step."""


def read(run):
    if not run.count.get("steps"):
        return None
    return run.count["steps"] / run.window_s
