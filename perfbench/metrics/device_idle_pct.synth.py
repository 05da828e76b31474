"""The share of the profiler slice (one batch after the window) in which no
operation ran on the card, in percent."""


def read(run):
    p = run.profile
    if not p or p["window_s"] <= 0 or not p["n_device_ops"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
