"""The readings that the limits of a cell's check are set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 --controls 3 \
        [--units 8] [--seconds 51] [--out chiprun_out/calibrate.jsonl]

For each seed: the cell's set-up and a short window at the cell's own
load (synthesis: ``--units`` batches; training: the cycles up to and
including the one that a run of ``--seconds`` holds for its check, whose
place in the window is drawn from the seed), then
the check against the reference: the program's readings, the lower ends
of the limits. On the first ``--controls`` seeds also each control that
the cell's file names under ``controls`` (the reference put in the
program's place in the next precision below the configuration's, against
the float32 reference) and each fault under ``faults``, planted in the
reference put in the program's place. The largest program reading and
each control's smallest reading of each number are printed last. The
benchmark's runs never run this.
"""

import argparse
import gc
import json
import os
import sys
import time

if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.getcwd())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--units", type=int, default=8)
    p.add_argument("--seconds", type=float, default=51)
    p.add_argument("--first_seed", type=int, default=3_000_000_000)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from perfbench import harness, program
    from perfbench.reference.precision import set_tf32

    harness.set_caches()
    entry, cell, cfg, manifest = harness.load_cell(args.workload)
    device = torch.device(args.device)
    set_tf32(bool(cfg["precision"]["tf32"]))
    kind = harness.load_module("traffic", cell["traffic"])
    train = cell["traffic"] == "train_cycle"
    lines = []

    def emit(rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    for j in range(args.seeds):
        seed = args.first_seed + 7919 * j
        t0 = time.perf_counter()
        traffic = kind.Traffic(cell, cfg, seed, device, False, args.seconds)
        traffic.setup(program)
        units = 0
        while (units < args.units if not train
               else traffic.window_start is None):
            traffic.unit()
            units += 1
        traffic.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        emit(dict(seed=seed, side="program", **traffic.check(),
                  setup_s=t1 - t0, units=units,
                  check_s=time.perf_counter() - t1))
        if hasattr(traffic, "look"):
            emit(dict(seed=seed, look=traffic.look))
        if j < args.controls:
            t2 = time.perf_counter()
            for side, gaps in traffic.controls(
                    cell["controls"], cell.get("faults", [])).items():
                emit(dict(seed=seed, side=side, **gaps))
            emit(dict(seed=seed, controls_s=time.perf_counter() - t2))
        del traffic
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    readings = [r for r in lines if "side" in r]
    names = [k for k in readings[0] if k.endswith("_gap")]
    sides = sorted({r["side"] for r in readings} - {"program"})
    summary = {}
    for n in names:
        prog = [r[n] for r in readings if r["side"] == "program"]
        summary[n] = {"program_max": max(prog),
                      "program_sorted": sorted(prog)}
        for side in sides:
            summary[n][side + "_min"] = min(r[n] for r in readings
                                            if r["side"] == side)
    emit({"summary": summary, "device": (
        torch.cuda.get_device_name(device) if device.type == "cuda"
        else "cpu"), "power_limit": harness.smi()})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
