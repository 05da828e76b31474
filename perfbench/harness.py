"""One run of one cell: set-up, the measured window, the traced slice, the
check, and the result's line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``perfbench/configs/<config>.json``) and a traffic kind; the cell's own
file (``perfbench/workloads/<cell>.json``) holds its traffic's parameters
and the limits of its check; ``perfbench/traffic/<kind>.py`` runs it; each
per-layer metric is read by ``perfbench/metrics/<metric>.py``.

The window is closed-loop: the next unit (a batch, or a G/G/D cycle) starts
when the last has finished, and the window ends at the first unit boundary
after ``--seconds``; an end-to-end rate is all the work it completed over
all its time. ``--trace 1`` adds host spans around each layer's call
(synchronized) and, after the window, one unit under the profiler; its line
carries the per-layer metrics instead of the end-to-end ones.
"""

import argparse
import copy
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import types

ROOT = os.getcwd()
HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "gantron_tpu")
GIB = 1024 ** 3


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


def run_window(traffic, seconds):
    """Units until the first boundary after ``seconds``: (window seconds,
    units)."""
    t0 = time.perf_counter()
    units = 0
    while True:
        traffic.unit()
        units += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return elapsed, units


def read_checks(values, limits):
    """{name: {"value", "limit"}} and whether each is within its limit (a
    number with no limit fails)."""
    out, ok = {}, True
    for name, value in values.items():
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value <= limit
    return out, ok


def measure(args, entry, cell, cfg, manifest, device, program):
    """Set-up, window, optional trace and check of one cell on ``device``.
    Returns the result's fields (without ``device``)."""
    import torch

    from perfbench.reference.precision import set_tf32

    set_tf32(bool(cfg["precision"]["tf32"]))
    kind = load_module("traffic", cell["traffic"])
    traffic = kind.Traffic(cell, cfg, args.seed, device, bool(args.trace),
                           args.seconds)
    before = process_start_s()
    traffic.setup(program)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = process_start_s()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window_s, units = run_window(traffic, args.seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    # What the host and the card were doing as the window closed: the
    # runs' spread comes from here (PERF.md).
    host = {"loadavg": os.getloadavg(),
            "card": smi("clocks.sm,power.draw,temperature.gpu")}
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
            spans=copy.deepcopy(traffic.spans),
            count=copy.deepcopy(traffic.count))
        run.profile = profile_unit(traffic.unit, device)
        run.profiled = getattr(traffic, "last_unit", {})
        for m in manifest["per_layer"]:
            if entry["name"] not in m.get("workloads", [entry["name"]]):
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


def main(argv=None):
    args = parse_args(argv)
    set_caches()
    entry, cell, cfg, manifest = load_cell(args.workload)
    import torch

    # The program first: in a checkout without it, fail before anything.
    from perfbench import program

    program.hparams(cfg)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    r = measure(args, entry, cell, cfg, manifest, device, program)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips, "memory_peak_bytes": r["peak"],
           "power_limit": smi()}
    if args.trace:
        dev.update(busy_s=r["busy_s"], window_s=r["slice_s"])
    result = {"correct": r["correct"], "attempted": r["attempted"],
              "failed": r["failed"], "metrics": r["metrics"], "device": dev,
              "units": r["units"], "run_window_s": r["window_s"],
              "check_s": r["check_s"], "host": r["host"],
              "setup_parts": r["setup_parts"]}
    if args.trace:
        result["breakdown"] = r["breakdown"]
        result["trace_reduce_s"] = r["trace_reduce_s"]
    result["checks"] = r["checks"]
    # Once the window has closed, in the process that prints the result.
    found = forbidden_modules()
    if found:
        print("loaded in the measuring process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for name, c in r["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
