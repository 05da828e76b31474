"""One run of one cell: set-up, the measured window, the traced slice, the
check, and the result's line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``perfbench/configs/<config>.json``) and a traffic kind; the cell's own
file (``perfbench/workloads/<cell>.json``) holds its traffic's parameters
and the limits of its check; ``perfbench/traffic/<kind>.py`` runs it; each
per-layer metric is read by ``perfbench/metrics/<metric>.py``; the
configuration's ``program`` names the adapter ``perfbench/programs/<name>.py``
through which the traffic reaches the program under test.

So a new model needs only new files and new entries in ``BENCHMARK.json``:
an adapter under ``programs/``; a configuration under ``configs/``; a
traffic kind under ``traffic/``; its weights, counts and plain reference
(``weights.py`` beside the others, ``counts/``, ``reference/``); a reader
under ``metrics/`` for each per-layer metric; and a cell file under
``workloads/``.

The window is closed-loop: the next unit (a batch, or a G/G/D cycle) starts
when the last has finished, and the window ends at the first unit boundary
after ``--seconds``; an end-to-end rate is all the work it completed over
all its time. ``--trace 1`` adds host spans around each layer's call
(synchronized) and, after the window, one unit under the profiler; its line
carries the per-layer metrics instead of the end-to-end ones.

A cell on more than one card runs one process a card (``launch``), each
joined to the program's process group; they run the traffic in step, rank
0 decides when the window ends and tells the others at each unit boundary,
and the launching process prints rank 0's line once every rank has ended
well. A rank that fails ends them all, and nothing is printed.
"""

import argparse
import copy
import gc
import importlib.util
import json
import os
import queue
import socket
import subprocess
import sys
import time
import traceback
import types

ROOT = os.getcwd()
HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "gantron_tpu")
GIB = 1024 ** 3
# A collective that waits this long for a rank raises (the program's group).
GROUP_TIMEOUT_S = 300.0
# Past this, the launching process ends every rank: over the first run's
# 1,200 seconds' allowance, a run would be refused anyway.
LAUNCH_DEADLINE_S = 1150.0


def process_start_s() -> float:
    """Seconds since this process started, from the kernel's record
    (falls back to this module's import)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(*parts):
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def load_cell(name, manifest=None):
    """(the manifest's entry, the cell's file, its configuration file)."""
    manifest = manifest or load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"]
                     if c["name"] == entry["config"])
    cell = load_json(HERE, "workloads", name + ".json")
    cfg = load_json(ROOT, cfg_entry["file"])
    if cell["traffic"] != entry["traffic"] or cell["config"] != entry[
            "config"]:
        raise SystemExit(f"{name}: workloads/{name}.json disagrees with "
                         "BENCHMARK.json")
    return entry, cell, cfg, manifest


def load_module(kind, name):
    """``perfbench/<kind>/<name>.py`` (a name may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_program(cfg):
    """The configuration's program adapter: ``perfbench/programs/<name>``."""
    return load_module("programs", cfg["program"])


def forbidden_modules():
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def smi(fields="name,power.limit"):
    """``nvidia-smi``'s reading of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def set_caches():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own nvcc build stays in gantron_tpu_torch/_build/)."""
    cache = os.path.join(ROOT, ".perfbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def run_window(traffic, seconds, group=None):
    """Units until the first boundary after ``seconds`` (in a group, by rank
    0's clock): (window seconds, units, each unit's seconds)."""
    t0 = time.perf_counter()
    ends = [t0]
    while True:
        traffic.unit()
        ends.append(time.perf_counter())
        elapsed = ends[-1] - t0
        done = elapsed >= seconds
        if group is not None:
            done = group.chief_says(done)
        if done:
            return elapsed, len(ends) - 1, [b - a for a, b in zip(ends,
                                                                 ends[1:])]


class HostWatch:
    """What the host did while the window ran, for reading a run's spread
    against: this process's CPU seconds and involuntary context switches,
    the machine's steal seconds (``/proc/stat``; None where it has none),
    and the garbage collector's passes and seconds, by generation."""

    def __init__(self):
        self.gc_s, self.gc_n = [0.0] * 3, [0] * 3
        self._t = None
        self.start = self.counters()
        gc.callbacks.append(self._gc)

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = info["generation"]
            self.gc_s[g] += time.perf_counter() - self._t
            self.gc_n[g] += 1
            self._t = None

    @staticmethod
    def counters():
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        try:
            with open("/proc/stat") as f:
                steal = int(f.readline().split()[8]) / os.sysconf(
                    "SC_CLK_TCK")
        except (OSError, ValueError, IndexError):
            steal = None
        return {"cpu_s": ru.ru_utime + ru.ru_stime, "nivcsw": ru.ru_nivcsw,
                "steal_s": steal}

    def stop(self):
        gc.callbacks.remove(self._gc)
        end = self.counters()
        out = {k: None if self.start[k] is None else end[k] - self.start[k]
               for k in end}
        out.update(gc_s=self.gc_s, gc_n=self.gc_n)
        return out


def read_checks(values, limits):
    """{name: {"value", "limit"}} and whether each is within its limit (a
    number with no limit fails)."""
    out, ok = {}, True
    for name, value in values.items():
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value <= limit
    return out, ok


def measure(args, entry, cell, cfg, manifest, device, program, group=None):
    """Set-up, window, optional trace and check of one cell on ``device``;
    with ``group`` (``perfbench.group.Group``), this rank's share of them.
    Returns the result's fields (without ``device``); in a group, rank 0's
    are the cell's."""
    import torch

    from perfbench.reference.precision import set_tf32

    set_tf32(bool(cfg["precision"]["tf32"]))
    kind = load_module("traffic", cell["traffic"])
    traffic = kind.Traffic(cell, cfg, args.seed, device, bool(args.trace),
                           args.seconds,
                           **({} if group is None else {"group": group}))
    since_start = process_start_s if group is None else group.since_start
    chief = group is None or group.rank == 0
    before = since_start()
    traffic.setup(program)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if group is not None:
        group.barrier()
    setup_s = since_start()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    watch = HostWatch()
    window_s, units, unit_s = run_window(traffic, args.seconds, group)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    watched = watch.stop()
    if group is not None:
        # The fullest card's.
        peak = int(group.max(peak))
    # What the host and the card were doing as the window closed: the
    # runs' spread comes from here (PERF.md).
    host = {"loadavg": os.getloadavg(),
            "card": smi("clocks.sm,power.draw,temperature.gpu"),
            **watched, "unit_s": unit_s}
    attempted, failed = traffic.attempted_failed()
    metrics, extra = {}, {}
    names = [m["name"] for m in manifest["end_to_end"]
             if entry["name"] in m.get("workloads", [entry["name"]])]
    units_of = {m["name"]: m["unit"] for m in manifest["end_to_end"]
                + manifest["per_layer"]}
    if not args.trace:
        values = dict(traffic.end_to_end(window_s), setup_s=setup_s,
                      peak_mem_gib=peak / GIB)
        metrics = {n: {"value": values[n], "unit": units_of[n]}
                   for n in names if n in values}
    else:
        from perfbench.trace import profile_unit

        run = types.SimpleNamespace(
            cfg=cfg, cell=cell, window_s=window_s, units=units,
            chips=1 if group is None else group.world,
            spans=copy.deepcopy(traffic.spans),
            count=copy.deepcopy(traffic.count))
        if not chief:
            # The other ranks run the profiled unit in step, unprofiled.
            traffic.unit()
            run.profile = dict(busy_s=None, window_s=None, device_ops=[],
                               idle_gaps=[], reduce_s=None)
        else:
            run.profile = profile_unit(traffic.unit, device)
        run.profiled = getattr(traffic, "last_unit", {})
        for m in manifest["per_layer"]:
            if not chief or entry["name"] not in m.get("workloads",
                                                       [entry["name"]]):
                continue
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = dict(busy_s=run.profile["busy_s"],
                     slice_s=run.profile["window_s"],
                     breakdown={"device_ops": run.profile["device_ops"],
                                "idle_gaps": run.profile["idle_gaps"]},
                     trace_reduce_s=run.profile["reduce_s"])
    traffic.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    gaps = traffic.check()
    checks, ok = read_checks(gaps, cell["limits"])
    return dict(correct=bool(ok and failed == 0), attempted=attempted,
                failed=failed, metrics=metrics, peak=peak, units=units,
                window_s=window_s, check_s=time.perf_counter() - t,
                checks=checks, host=host,
                setup_parts=dict(start=before, **traffic.setup_parts),
                **extra)


def result_line(r, device, chips, trace):
    """The result's line (a dict) of ``measure``'s fields."""
    import torch

    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": r["peak"],
           "power_limit": smi() if cuda else None}
    if trace:
        dev.update(busy_s=r["busy_s"], window_s=r["slice_s"])
    result = {"correct": r["correct"], "attempted": r["attempted"],
              "failed": r["failed"], "metrics": r["metrics"], "device": dev,
              "units": r["units"], "run_window_s": r["window_s"],
              "check_s": r["check_s"], "host": r["host"],
              "setup_parts": r["setup_parts"]}
    if trace:
        result["breakdown"] = r["breakdown"]
        result["trace_reduce_s"] = r["trace_reduce_s"]
    result["checks"] = r["checks"]
    return result


def report(result):
    """Prints the result's line, its checks last on standard error; or,
    where JAX or the JAX package is loaded in this process, nothing.
    Returns the exit code."""
    # Once the window has closed, in the process that prints the result.
    found = forbidden_modules()
    if found:
        print("loaded in the measuring process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def measure_rank(payload, device, program, group):
    """``launch``'s work for a run of the harness: ``measure`` on this rank;
    rank 0's result line."""
    args, entry, cell, cfg, manifest = payload
    r = measure(args, entry, cell, cfg, manifest, device, program, group)
    return result_line(r, device, group.world, args.trace)


def run_group(args, entry, cell, cfg, manifest, devices, backend, hook=None):
    """A run of a cell in one process a device of ``devices``: rank 0's line
    printed once every rank has ended well. Returns the exit code."""
    rc, result = launch(measure_rank, (args, entry, cell, cfg, manifest),
                        devices, backend, hook)
    return report(result) if rc == 0 else rc


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_listening(port, timeout_s):
    """Returns once a socket of this host listens on ``port`` (the kernel's
    tables, ``/proc/net/tcp*``; at once where it has none). A rank that
    dialled rank 0's store before it listened could be handed that very
    port as its own end, connect to itself and keep rank 0 from
    listening."""
    tables = [t for t in ("/proc/net/tcp", "/proc/net/tcp6")
              if os.path.exists(t)]
    want = f":{port:04X}"
    deadline = time.time() + timeout_s
    while tables and time.time() < deadline:
        for table in tables:
            with open(table) as f:
                next(f)
                for line in f:
                    local, state = line.split()[1], line.split()[3]
                    if local.endswith(want) and state == "0A":  # LISTEN
                        return
        time.sleep(0.05)
    if tables:
        raise TimeoutError(f"nothing listens on port {port}")


def launch(work, payload, devices, backend, hook=None,
           timeout_s=GROUP_TIMEOUT_S, deadline_s=LAUNCH_DEADLINE_S):
    """Runs ``work(payload, device, program, group)`` in one process a
    device of ``devices``, each joined to the program's process group over
    ``backend`` (its exchanges raise after ``timeout_s``), with a fresh
    import (``spawn``). ``payload[3]`` is the configuration.
    ``hook(rank, program)``, where given, runs in each process before it
    joins (a planted fault). Returns (0, rank 0's return value) once every
    process has ended well; (1, None) as soon as one has not, or at
    ``deadline_s`` after this process started, with every process
    ended."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    origin = time.time() - process_start_s()
    address = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=rank_main, args=(
        rank, len(devices), str(device), backend, address, timeout_s, origin,
        work, payload, hook, results))
        for rank, device in enumerate(devices)]
    for p in procs:
        p.start()
    result, rc = None, 1
    try:
        while time.time() - origin < deadline_s:
            try:
                result = results.get(timeout=0.5)
            except queue.Empty:
                pass
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                print(f"perfbench: rank exit codes {codes}", file=sys.stderr)
                break
            if all(c == 0 for c in codes):
                if result is None:
                    try:
                        result = results.get(timeout=5)
                    except queue.Empty:
                        pass
                rc = 0 if result is not None else 1
                break
        else:
            print(f"perfbench: the ranks did not end within {deadline_s} s",
                  file=sys.stderr)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(30)
    return rc, result if rc == 0 else None


def rank_main(rank, world, device, backend, address, timeout_s, origin, work,
              payload, hook, results):
    """One rank of ``launch``: its card, the program's group, the work;
    rank 0 puts what the work returns on ``results``."""
    import torch

    from perfbench.group import Group

    # One intra-op thread a process, as torchrun sets for more than one.
    torch.set_num_threads(1)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cfg = payload[3]
    program = load_program(cfg)
    if hook is not None:
        hook(rank, program)
    if rank:
        wait_listening(int(address.rsplit(":", 1)[1]), timeout_s)
    program.join_group(address, world, rank, backend, timeout_s)
    try:
        out = work(payload, device, program,
                   Group(rank, world, device, backend, origin))
    except Exception:
        # Out at once: leaving the group could wait on the ranks' pending
        # exchanges; the launching process ends them.
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    program.leave_group()
    found = forbidden_modules()
    if found:
        raise SystemExit("loaded in a measuring process: " + ", ".join(found))
    if rank == 0:
        results.put(out)


def main(argv=None):
    args = parse_args(argv)
    set_caches()
    entry, cell, cfg, manifest = load_cell(args.workload)
    import torch

    # The program first: in a checkout without it, fail before anything.
    program = load_program(cfg)
    program.check(cfg)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    if chips > 1:
        return run_group(args, entry, cell, cfg, manifest,
                         [f"cuda:{r}" for r in range(chips)], "nccl")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    r = measure(args, entry, cell, cfg, manifest, device, program)
    return report(result_line(r, device, chips, args.trace))
