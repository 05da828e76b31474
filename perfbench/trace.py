"""The profiler slice of a traced run, reduced in memory.

One unit of the cell's work (a batch or a G/G/D cycle) runs under
``torch.profiler`` with the host and the card; nothing is written to disk.
From its events: the slice's length, the seconds in which any operation
ran on the card (the union of their intervals), each device operation's
total seconds by name, and the card's idle gaps, each put to the host
operation that was running at its middle (the innermost one; launches and
other runtime calls are passed over for the operator that made them)."""

import heapq
import time
from collections import Counter

import torch

MARK = "perfbench.unit"
# Host events of the profiler's own bookkeeping, never the program's.
PROFILER_OWN = {"Activity Buffer Request"}


def _ns(e, what):
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return f()
    return getattr(e, what + "_us")() * 1000


def profile_unit(fn, device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(MARK):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    summary = summarize(prof.profiler.kineto_results.events())
    summary["reduce_s"] = time.perf_counter() - t1
    summary["profiled_s"] = t1 - t0
    return summary


def summarize(events):
    dev, host = [], []
    w0 = w1 = None
    for e in events:
        name = e.name()
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        on_device = "CUDA" in str(e.device_type())
        if name == MARK:
            # Kineto mirrors the annotation on the device's timeline too.
            if not on_device:
                w0, w1 = start, end
        elif on_device:
            if not e.is_user_annotation():
                dev.append((start, end, name))
        elif name not in PROFILER_OWN:
            host.append((start, end, name))
    if w0 is None:
        raise RuntimeError("the profiler recorded no unit")
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    dev.sort()
    ops = Counter()
    busy, gaps, cur_s, cur_e = 0, [], None, None
    last_end = w0
    for s, e, n in dev:
        ops[n[:160]] += (e - s) * 1e-9
        if s > last_end:
            gaps.append((last_end, s))
        last_end = max(last_end, e)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > last_end:
        gaps.append((last_end, w1))
    idle = Counter()
    host = sorted(h for h in host if not h[2].startswith(("cuda", "cu")))
    # Sweep the gaps' middles in order; the heap holds the host operators
    # begun so far, latest start on top; one that ended before this middle
    # ended before every later one too.
    heap, at = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) // 2
        while at < len(host) and host[at][0] <= mid:
            heapq.heappush(heap, (-host[at][0], host[at][1], host[at][2]))
            at += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        label = heap[0][2] if heap else "host, outside any operator"
        idle[label[:160]] += (b - a) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9,
            "device_ops": [[n, s] for n, s in ops.most_common(10)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(10)],
            "kernels": dict(ops), "n_device_ops": len(dev)}
