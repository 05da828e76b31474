"""Profiling, tracing and timing helpers (port of
gantron_tpu/utils/profiling.py).

``trace(dir)`` runs ``torch.profiler`` over the host and the card and writes
a Chrome trace into ``dir`` (open it in Perfetto or ``chrome://tracing``),
with ``spans.json`` beside it; ``StepTimer`` times a step with the host
clock, after the card has finished the step's work when ``sync=True``;
``benchmark`` gives the mean seconds of one call with every call's work
finished.

Spans. The program marks its layers with ``span(name)`` (``with
span("decoder.step"): ...``) or ``spanned(name)`` (a method's decorator).
A span records only while a torch profiler is recording or inside
``tracing()``; otherwise it is one flag check, with no host sync, no CUDA
event, no allocation and no random draw. Under a profiler it opens
``torch.profiler.record_function("gantron/<name>")``, so the span lies on
the clock of the card's trace: it shows in a Chrome trace and names the
host's idle gaps in a profiler slice. Inside ``tracing()`` it also appends
to an in-memory record: its name, its parent (the span that was open when
it opened), its host start and end (``time.perf_counter_ns``) and, on a
machine with a card, a CUDA event at each end on the current stream (not
for ``decoder.step``: in a loop of launches an event pair cost ≈ 50 µs of
host time a step on an H100, and ``decoder.loop``'s pair covers the
steps). The events are read only by ``summary()``, after one synchronize.

``summary()`` reduces the last ``tracing()`` session, for each span name:
``calls``, ``host_s`` (the host's seconds inside it), ``self_s`` (``host_s``
less its child spans'), ``device_s`` (the sum of the stream's seconds
between its two events; None without events) and ``parents`` (the names
of the spans it opened inside), plus ``counters``, the session's deltas of
the kernel launch counters ``qmm.launches`` and ``log_mel.launches`` and of
``flowtron.energy_elements`` (the elements of the additive attention's
score grid that ``ops/attention.py`` materialised).
``trace(dir)`` writes that dict as ``spans.json``: ``calls`` of
``decoder.step`` are the decoder's steps, ``counters["qmm.launches"]`` over
them the int8 launches a step, ``self_s`` the host time a layer spends
outside its children. The spans are (``<layer>.<part>``):
``tacotron2.infer``, ``encoder``, ``decoder.loop``, ``decoder.step``,
``postnet``, ``vocoder.infer``, ``vocoder.upsample``, ``vocoder.flows``;
``g_step`` with ``g_step.identification``, ``g_step.forward``,
``g_step.loss``, ``g_step.backward``, ``g_step.deferred_dw``,
``g_step.all_reduce``, ``g_step.update``; ``d_step`` with
``d_step.forward``, ``d_step.backward``, ``d_step.update``; Flowtron's
``flowtron.step`` with ``flowtron.forward`` (``encoder``, then a
``flowtron.flow`` a flow, each with its ``flowtron.lstm`` pair and its
``flowtron.attention``), ``flowtron.loss``, ``flowtron.backward``,
``flowtron.update``; ``flowtron.infer`` with ``encoder`` and
``flowtron.infer.step`` (no CUDA events, as ``decoder.step``). A session
holds every span it records, with its events, until the next session
starts.
"""

import contextlib
import functools
import json
import os
import time
from collections import defaultdict

import torch

from gantron_tpu_torch.ops.attention import additive_attention
from gantron_tpu_torch.ops.mel import log_mel
from gantron_tpu_torch.ops.quant import qmm

PREFIX = "gantron/"
_profiler_enabled = torch._C._autograd._profiler_enabled


def _counters():
    return {"qmm.launches": qmm.launches, "log_mel.launches": log_mel.launches,
            "flowtron.energy_elements": additive_attention.energy_elements}


class Record:
    """One ``tracing()`` session: its spans in the order they opened, each
    [name, parent index (-1 at the top), host start ns, host end ns, start
    event, end event], and the launch counters at its start and end."""

    def __init__(self):
        self.spans = []
        self.open = []
        self.cuda = torch.cuda.is_available()
        self.counters_at_start = _counters()
        self.counters_at_end = None

    def enter(self, name, events):
        event = None
        if self.cuda and events:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        self.open.append(len(self.spans))
        parent = self.open[-2] if len(self.open) > 1 else -1
        self.spans.append([name, parent, time.perf_counter_ns(), None, event,
                           None])

    def exit(self):
        row = self.spans[self.open.pop()]
        row[3] = time.perf_counter_ns()
        if row[4] is not None:
            row[5] = torch.cuda.Event(enable_timing=True)
            row[5].record()

    def summary(self):
        if self.cuda:
            torch.cuda.synchronize()
        calls, host, child = (defaultdict(int) for _ in range(3))
        device, parents = {}, defaultdict(set)
        for name, parent, t0, t1, e0, e1 in self.spans:
            if t1 is None:  # still open
                continue
            calls[name] += 1
            host[name] += t1 - t0
            if e0 is not None:
                device[name] = (device.get(name, 0.0)
                                + e0.elapsed_time(e1) * 1e-3)
            if parent >= 0:
                child[self.spans[parent][0]] += t1 - t0
                parents[name].add(self.spans[parent][0])
        end = self.counters_at_end or _counters()
        return {
            "spans": {n: dict(calls=calls[n], host_s=host[n] * 1e-9,
                              self_s=(host[n] - child[n]) * 1e-9,
                              device_s=device.get(n),
                              parents=sorted(parents[n]))
                      for n in calls},
            "counters": {k: end[k] - v
                         for k, v in self.counters_at_start.items()}}


_record = None    # the session that spans append to, inside tracing()
_last = Record()  # the last session, which summary() reads


_OFF = contextlib.nullcontext()  # what ``span`` returns while nothing records


class _Span:
    __slots__ = ("name", "events", "record", "function")

    def __init__(self, name, events, record):
        self.name, self.events, self.record = name, events, record
        self.function = None

    def __enter__(self):
        if _profiler_enabled():
            self.function = torch.profiler.record_function(PREFIX + self.name)
            self.function.__enter__()
        if self.record is not None:
            self.record.enter(self.name, self.events)

    def __exit__(self, *exc):
        if self.record is not None:
            self.record.exit()
        if self.function is not None:
            self.function.__exit__(*exc)
        return False


def span(name: str, events: bool = True):
    """A context manager that marks a layer of the program as ``name``
    (module docstring); it does nothing unless a profiler records or
    ``tracing()`` is on. ``events=False`` takes no CUDA events: for a span
    opened once a loop step, whose events would cost more than the step's
    own host time can hide (its loop's span measures the card)."""
    if _record is None and not _profiler_enabled():
        return _OFF
    return _Span(name, events, _record)


def spanned(name: str):
    """Decorator: the function's every call inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


@contextlib.contextmanager
def tracing():
    """Record every span opened inside into a new session (the last one's
    spans are dropped); ``summary()`` reads it, inside or after. Yields the
    session's ``Record``."""
    global _record, _last
    record = _last = Record()
    _record = record
    try:
        yield record
    finally:
        record.counters_at_end = _counters()
        _record = None


def summary() -> dict:
    """The last ``tracing()`` session's spans and counters (module
    docstring); waits for the card once to read the span's events."""
    return _last.summary()


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Profile the host and, where there is one, the card, with the
    program's spans recorded: ``with trace('out/trace') as prof:
    run_steps()`` writes ``out/trace/<name>`` and ``out/trace/spans.json``
    (``summary()``); ``prof`` is the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tracing(), profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, name))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(summary(), f, indent=1, sort_keys=True)


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
