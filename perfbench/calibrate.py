"""The readings that the limits of a cell's check are set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 --controls 3 \
        [--units 8] [--seconds 51] [--out chiprun_out/calibrate.jsonl]

For each seed: the cell's set-up and a short window at the cell's own
load (``--units`` units; for a traffic kind whose check holds a unit of
the window, as training's does, the units up to and including the one that
a run of ``--seconds`` holds, whose place in the window is drawn from the
seed: such a kind has ``window_start``, None until it holds that unit), then
the check against the reference: the program's readings, the lower ends
of the limits. On the first ``--controls`` seeds also each control that
the cell's file names under ``controls`` (the reference put in the
program's place in the next precision below the configuration's, against
the float32 reference), each fault under ``faults``, planted in the
reference put in the program's place, and each fault under
``program_faults``, planted in the program (its adapter's ``plant``) for
a run of its own. The largest program reading and each control's smallest
reading of each number are printed last. A cell on more than one card
runs as the harness runs it, one process a card (``harness.launch``),
every seed in the same processes; rank 0 prints. The benchmark's runs
never run this.
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


def readings(payload, device, program, group=None):
    """Every seed's readings (on rank 0; the other ranks' are []): the
    program's, and on the first seeds the controls' and the faults'."""
    import torch

    from perfbench import harness
    from perfbench.reference.precision import set_tf32

    args, entry, cell, cfg = payload
    chief = group is None or group.rank == 0
    set_tf32(bool(cfg["precision"]["tf32"]))
    kind = harness.load_module("traffic", cell["traffic"])
    lines = []

    def emit(rec):
        if chief:
            lines.append(rec)
            print(json.dumps(rec), flush=True)

    def free():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def program_run(seed):
        """Set-up, the window up to its held cycle (training) or
        ``--units`` units, the check: (traffic, gaps, units, seconds)."""
        t0 = time.perf_counter()
        traffic = kind.Traffic(cell, cfg, seed, device, False, args.seconds,
                               **({} if group is None else {"group": group}))
        traffic.setup(program)
        holds = hasattr(traffic, "window_start")
        units = 0
        while (traffic.window_start is None if holds
               else units < args.units):
            traffic.unit()
            units += 1
        traffic.release()
        free()
        return traffic, traffic.check(), units, time.perf_counter() - t0

    for j in range(args.seeds):
        seed = args.first_seed + 7919 * j
        traffic, gaps, units, run_s = program_run(seed)
        emit(dict(seed=seed, side="program", **gaps, run_s=run_s,
                  units=units))
        if hasattr(traffic, "look"):
            emit(dict(seed=seed, look=traffic.look))
        if j < args.controls:
            t2 = time.perf_counter()
            if chief:
                for side, gaps in traffic.controls(
                        cell["controls"], cell.get("faults", [])).items():
                    emit(dict(seed=seed, side=side, **gaps))
            for fault in cell.get("program_faults", []):
                undo = program.plant(fault, 0 if group is None
                                     else group.rank)
                try:
                    _, gaps, units, run_s = program_run(seed)
                finally:
                    undo()
                emit(dict(seed=seed, side=fault, **gaps, run_s=run_s,
                          units=units))
            emit(dict(seed=seed, controls_s=time.perf_counter() - t2))
        del traffic
        free()
    return lines


def summarize(lines):
    """{number: the program's largest and sorted readings, and each other
    side's least reading of it (where that side reads it)}."""
    rows = [r for r in lines if "side" in r]
    names = [k for k in rows[0] if k.endswith("_gap")]
    sides = sorted({r["side"] for r in rows} - {"program"})
    summary = {}
    for n in names:
        prog = [r[n] for r in rows if r["side"] == "program"]
        summary[n] = {"program_max": max(prog),
                      "program_sorted": sorted(prog)}
        for side in sides:
            got = [r[n] for r in rows if r["side"] == side and n in r]
            if got:
                summary[n][side + "_min"] = min(got)
    return summary


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

    from perfbench import harness

    harness.set_caches()
    entry, cell, cfg, manifest = harness.load_cell(args.workload)
    chips = int(entry["chips"])
    payload = (args, entry, cell, cfg)
    if chips > 1:
        # Every seed in one set of processes; an exchange may wait while
        # rank 0 runs the reference alone.
        rc, lines = harness.launch(
            readings, payload, [f"cuda:{r}" for r in range(chips)], "nccl",
            timeout_s=1800.0, deadline_s=3500.0)
        if rc:
            return rc
    else:
        lines = readings(payload, torch.device(args.device),
                         harness.load_program(cfg))
    rec = {"summary": summarize(lines), "device": (
        torch.cuda.get_device_name(0) if args.device == "cuda"
        else "cpu"), "chips": chips, "power_limit": harness.smi()}
    print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            for r in lines + [rec]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
