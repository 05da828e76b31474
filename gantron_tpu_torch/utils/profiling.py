"""Profiling and timing helpers (port of gantron_tpu/utils/profiling.py).

``trace(dir)`` runs ``torch.profiler`` over the host and the card and writes
a Chrome trace into ``dir`` (open it in Perfetto or ``chrome://tracing``);
``StepTimer`` times a step with the host clock, after the card has finished
the step's work when ``sync=True``; ``benchmark`` gives the mean seconds of
one call with every call's work finished.
"""

import contextlib
import os
import time

import torch


def _sync(*tensors):
    """Wait for the cards that hold ``tensors`` (nested in lists, tuples or
    dicts; a ``torch.device`` stands for its card) to finish their queued
    work."""
    seen = set()

    def visit(x):
        if isinstance(x, (torch.Tensor, torch.device)):
            device = x.device if isinstance(x, torch.Tensor) else x
            if device.type == "cuda" and device not in seen:
                seen.add(device)
                torch.cuda.synchronize(device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tensors)


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Profile the host and, where there is one, the card:
    ``with trace('out/trace') as prof: run_steps()`` writes
    ``out/trace/<name>``; ``prof`` is the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, name))


class StepTimer:
    """Host-clock step timing. With ``sync``, ``stop(*outputs)`` first waits
    for the cards that hold ``outputs``, so that the time covers the work
    and not only their launch; ``start(*inputs)`` waits for the cards that
    hold ``inputs``, so that it leaves out work queued before the step.
    Tensors and ``torch.device``s may be given, nested in lists, tuples or
    dicts."""

    def __init__(self, sync: bool = False):
        self.sync = sync
        self._t0 = None

    def start(self, *sync_on):
        if self.sync and sync_on:
            _sync(sync_on)
        self._t0 = time.perf_counter()

    def stop(self, *sync_on) -> float:
        if self.sync and sync_on:
            _sync(sync_on)
        return time.perf_counter() - self._t0


def benchmark(fn, *args, warmup: int = 2, iters: int = 10) -> float:
    """Mean seconds of one ``fn(*args)`` over ``iters`` calls after
    ``warmup`` calls, with every card's work finished before the clock
    starts and before it stops."""
    for _ in range(warmup):
        fn(*args)
    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / iters
