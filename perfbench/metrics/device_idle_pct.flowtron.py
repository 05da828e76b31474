"""The share of a Flowtron training step in which no operation ran on the
card, in percent: the profiled step's busy time (the union of its device
operations in the profiler's slice) against the device extent of the
``flowtron.step`` span (its CUDA events) of the window's step over the
same pool batch, the one ``pool`` steps before it, which ran without the
profiler. So the profiler's own cost on the host, which stretches the
profiled step and its slice, stays out of the share. Nothing to read where
the program has no such span."""


def read(run):
    p = run.profile
    extents = run.spans.get("flowtron.step", [])
    pool = int(run.cell["params"]["pool"])
    if not p or not p["n_device_ops"] or len(extents) < pool:
        return None
    return 100.0 * (1.0 - p["busy_s"] / extents[-pool])
