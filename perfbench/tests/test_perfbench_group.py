"""The cells on more than one card, at tiny widths on the CPU: their ranks
as two gloo processes (``harness.launch``, as the card's cells are run over
NCCL), and the harness's openness to another program.

A sound run reads correct on every number, ``rank_param_gap`` exactly 0;
with the timed path broken underneath (a state left unchanged, half of
each rank's rows left out, the exchange of gradients left out on every
rank but 0) it reads not correct; the control and the faults that
calibration reads fail the limits; the ranks' dropout draws are those that
the reference repeats; a rank that fails or hangs ends the run with a
nonzero code and no line. The limits are the committed ones."""

import copy
import functools
import hashlib
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from perfbench import calibrate, harness
from perfbench.tests import test_perfbench_check as one_card
from perfbench.tests.tiny import load, manifest, tiny

CPU2 = ["cpu", "cpu"]
SEED = 2 ** 31 + 4099
# Tiny sizes of each traffic kind's parameters: a global batch of 4 rows,
# two a rank.
TINY = {"train_cycle_dp": dict(batch=4, t_in=10, t_out=24)}


def with_held_out():
    """BENCHMARK.json with the entries of each cell held out of it: a cell
    file's ``manifest`` holds its ``workload`` entry, the metrics whose
    ``workloads`` lists it ``joins`` and its new ``per_layer`` entries,
    which a later change copies into BENCHMARK.json as they are
    (ljspeech.train_dp4: its runs spread too widely for the bound,
    PERF.md)."""
    m = copy.deepcopy(manifest())
    have = {w["name"] for w in m["workloads"]}
    for name in held_out():
        if name in have:
            continue
        held = load("workloads", name)["manifest"]
        m["workloads"].append(held["workload"])
        for e in m["end_to_end"] + m["per_layer"]:
            if e["name"] in held["joins"]:
                e["workloads"].append(name)
        m["per_layer"] += held["per_layer"]
    return m


def held_out():
    """The cells whose files carry the entries that they take in
    BENCHMARK.json."""
    folder = os.path.join(harness.HERE, "workloads")
    return sorted(f[:-len(".json")] for f in os.listdir(folder)
                  if "manifest" in load("workloads", f[:-len(".json")]))


GROUP_CELLS = [w["name"] for w in with_held_out()["workloads"]
               if w["chips"] > 1]


def test_the_held_out_entries_keep_the_contract():
    """What BENCHMARK.json's tests hold its entries to, for the entries
    that a held-out cell's file carries."""
    m = manifest()
    metrics = {e["name"] for e in m["end_to_end"] + m["per_layer"]}
    every_cell = {e["name"] for e in m["end_to_end"] if "workloads" not in e}
    for name in held_out():
        cell = load("workloads", name)
        held = cell["manifest"]
        w = held["workload"]
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert (w["name"], w["config"], w["traffic"], w["why"]) == (
            name, cell["config"], cell["traffic"], cell["why"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert set(held["joins"]) <= metrics
        for e in held["per_layer"]:
            assert set(e) == {"name", "unit", "better", "source", "layer",
                              "moves", "workloads"}
            assert e["name"] not in metrics and e["workloads"] == [name]
            assert e["moves"] in held["joins"] or e["moves"] in every_cell
            assert os.path.exists(os.path.join(
                harness.HERE, "metrics", e["name"] + ".py"))
    cells = with_held_out()["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def tiny_cell(cell_name):
    m = with_held_out()
    entry = tiny(cell_name, m)[0]
    return tiny(cell_name, m, **TINY[entry["traffic"]])


def run(cell_name, capfd, hook=None, seconds=1.0, trace=0):
    """(exit code, the parsed line or None, standard error) of a run on two
    gloo ranks."""
    entry, cell, cfg, manifest = tiny_cell(cell_name)
    args = types.SimpleNamespace(workload=cell_name, seed=SEED,
                                 seconds=seconds, trace=trace)
    rc = harness.run_group(args, entry, cell, cfg, manifest, CPU2, "gloo",
                           hook)
    out, err = capfd.readouterr()
    if rc:
        assert out == ""
        return rc, None, err
    lines = out.strip().splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0]), err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", GROUP_CELLS)
def test_a_sound_run_on_two_ranks_is_correct(cell, trace, capfd):
    rc, line, _ = run(cell, capfd, trace=trace)
    assert rc == 0
    assert line["correct"], line["checks"]
    assert line["checks"]["rank_param_gap"] == {"value": 0.0, "limit": 0}
    assert line["device"]["count"] == 2 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    names = set(line["metrics"])
    if trace:
        assert {"steps_per_s.train", "g_step_ms.train", "d_step_ms.train",
                "mfu.train"} <= names
        # No device here: no device operation to read, no NCCL kernel.
        assert not names & {"device_idle_pct.train", "allreduce_ms.train"}
        assert line["device"]["window_s"] > 0
    else:
        assert names == {"peak_mem_gib", "setup_s"}


# -- faults planted in every rank's program ---------------------------------
def planted(fault, rank, program):
    """``launch``'s hook: a fault of the one-card tests, or the adapter's."""
    if isinstance(fault, str):
        program.plant(fault, rank)
    else:
        fault(pytest.MonkeyPatch())


GROUP_FAULTS = ["no_all_reduce", one_card.unchanged_train_state,
                one_card.half_batch_train]


@pytest.mark.parametrize("fault", GROUP_FAULTS,
                         ids=lambda f: getattr(f, "__name__", f))
@pytest.mark.parametrize("cell", GROUP_CELLS)
def test_a_broken_run_on_two_ranks_is_not_correct(cell, fault, capfd):
    rc, line, _ = run(cell, capfd, functools.partial(planted, fault))
    assert rc == 0 and not line["correct"]


def test_no_all_reduce_shows_as_ranks_apart(capfd):
    rc, line, _ = run(GROUP_CELLS[0], capfd,
                      functools.partial(planted, "no_all_reduce"))
    assert line["checks"]["rank_param_gap"]["value"] > 0


@pytest.mark.parametrize("cell", GROUP_CELLS)
def test_the_control_and_the_faults_fail_the_limits(cell, capfd):
    """calibrate.py's readings on two ranks: the program's within the
    limits; each control, each fault of the reference put in the program's
    place and each fault planted in the program outside them."""
    entry, c, cfg, _ = tiny_cell(cell)
    args = types.SimpleNamespace(seeds=1, controls=1, units=0, seconds=1.0,
                                 first_seed=SEED)
    rc, lines = harness.launch(calibrate.readings, (args, entry, c, cfg),
                               CPU2, "gloo")
    assert rc == 0
    sides = {r["side"]: {k: v for k, v in r.items() if k.endswith("_gap")}
             for r in lines if "side" in r}
    assert set(sides) == {"program", *c["controls"], *c["faults"],
                          *c["program_faults"]} == {
        "program", "tf32", "half_batch", "no_all_reduce"}
    for side, gaps in sides.items():
        _, ok = harness.read_checks(gaps, c["limits"])
        assert ok == (side == "program"), (side, gaps)
    summary = calibrate.summarize(lines)
    assert set(summary) == set(c["limits"])
    # Only the program's runs read how far the ranks lie apart.
    assert set(summary["rank_param_gap"]) == {
        "program_max", "program_sorted", "no_all_reduce_min"}
    assert summary["rank_param_gap"]["program_max"] == 0


# -- the draws that the reference repeats -----------------------------------
def draws_work(payload, device, program, group):
    """After set-up's first cycle: every rank's dropout state, and the
    reference's ranks' after the same cycle (rank 0)."""
    cell, cfg = payload[2], payload[3]
    kind = harness.load_module("traffic", cell["traffic"])
    traffic = kind.Traffic(cell, cfg, SEED, device, False, 1.0, group=group)
    traffic.setup(program)
    states = group.gather(traffic.trainer.dropout_state())
    if group.rank:
        return None
    ref = kind.train_cycle.reference_cycle(cfg, cell["params"], SEED, device,
                                           ranks=group.world)
    return [torch.equal(a, b) for a, b in zip(states, ref["dropout_state"])]


@pytest.mark.parametrize("cell", GROUP_CELLS)
def test_the_ranks_draws_are_those_the_reference_repeats(cell):
    entry, c, cfg, manifest = tiny_cell(cell)
    rc, same = harness.launch(draws_work, (None, entry, c, cfg), CPU2,
                              "gloo")
    assert rc == 0
    assert same == [True, True], one_card.DRAWS.format(
        "each rank's G and D steps, from the rank's own generator: every "
        "dropout of its rows, layer by layer in the reference's order")


# -- a rank that fails ------------------------------------------------------
def raises_on_rank_one(rank, program):
    if rank == 1:
        raise RuntimeError("a planted failure of rank 1")


def hangs_on_rank_one(rank, program):
    if rank == 1:
        import time

        time.sleep(3600)


def test_a_rank_that_raises_leaves_a_nonzero_exit_and_no_line(capfd):
    rc, line, err = run(GROUP_CELLS[0], capfd, raises_on_rank_one)
    assert rc != 0 and line is None
    assert "a planted failure of rank 1" in err
    assert not multiprocessing.active_children()


def test_a_rank_that_hangs_ends_the_run_within_the_timeout(capfd):
    entry, cell, cfg, manifest = tiny_cell(GROUP_CELLS[0])
    args = types.SimpleNamespace(workload=GROUP_CELLS[0], seed=SEED,
                                 seconds=1.0, trace=0)
    rc, result = harness.launch(
        harness.measure_rank, (args, entry, cell, cfg, manifest), CPU2,
        "gloo", hangs_on_rank_one, timeout_s=5.0)
    assert rc != 0 and result is None
    assert capfd.readouterr().out == ""
    assert not multiprocessing.active_children()


# -- another program, by new files alone ------------------------------------
TOY = {
    "programs/toy.py": '''"""A toy program: one linear map, plain torch."""
TINY = {}


def check(cfg):
    return cfg["model"]["width"]


def defaults():
    return {"width": 8}


class Model:
    def __init__(self, W):
        self.W = W

    def __call__(self, x):
        return x @ self.W
''',
    "traffic/toy_rows.py": '''"""Rows through the toy model, closed loop;
the check holds the window's second unit, as training's holds a cycle."""
import torch


class Traffic:
    def __init__(self, cell, cfg, seed, device, trace, seconds):
        self.p, self.w, self.seed = cell["params"], cfg["model"]["width"], seed
        self.device = device
        self.spans = {"unit": []}
        self.count = {"rows": 0}
        self.window_start = None

    def setup(self, program):
        g = torch.Generator().manual_seed(self.seed)
        self.W = torch.randn(self.w, self.w, generator=g)
        self.x = torch.randn(self.p["rows"], self.w, generator=g)
        self.model = program.Model(self.W)
        self.setup_parts = {}

    def unit(self):
        self.y = self.model(self.x)
        self.spans["unit"].append(1e-3)
        self.count["rows"] += self.p["rows"]
        if self.window_start is None and len(self.spans["unit"]) == 2:
            self.window_start = self.y

    def end_to_end(self, window_s):
        return {"toy_rows_per_s": self.count["rows"] / window_s}

    def attempted_failed(self):
        return self.count["rows"], 0

    def release(self):
        self.model = None

    def check(self):
        ref = sum(self.x[:, k:k + 1] * self.W[k] for k in range(self.w))
        return {"out_gap": float((self.window_start - ref).abs().max())}
''',
    "metrics/toy_unit_ms.py": '''def read(run):
    spans = run.spans.get("unit")
    return 1e3 * sum(spans) / len(spans) if spans else None
''',
    "configs/toy.json": {
        "name": "toy", "source": "https://example.org/toy", "reduced": [],
        "program": "toy", "precision": {"tf32": False},
        "model": {"width": 8}},
    "workloads/toy.rows.json": {
        "name": "toy.rows", "config": "toy", "traffic": "toy_rows",
        "why": "rows through a toy model", "params": {"rows": 16},
        "limits": {"out_gap": 1e-5}},
}


def digest(folder):
    out = {}
    for dirpath, dirs, files in os.walk(folder):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, f), folder)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_new_program_runs_its_cell_with_new_files_alone(tmp_path):
    root = os.path.dirname(harness.HERE)
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path / "perfbench")
    for rel, body in TOY.items():
        with open(tmp_path / "perfbench" / rel, "w") as f:
            f.write(body if isinstance(body, str) else json.dumps(body))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["configs"].append({"name": "toy", "source": "https://example.org/toy",
                         "file": "perfbench/configs/toy.json", "reduced": [],
                         "why": "a toy program"})
    m["workloads"].append({"name": "toy.rows", "config": "toy",
                           "traffic": "toy_rows", "chips": 1,
                           "why": "rows through a toy model"})
    m["end_to_end"].append({"name": "toy_rows_per_s", "unit": "rows/s",
                            "better": "higher", "bound": 0.1,
                            "source": "host_clock", "workloads": ["toy.rows"]})
    m["per_layer"].append({"name": "toy_unit_ms", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "toy", "moves": "toy_rows_per_s",
                           "workloads": ["toy.rows"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(m, f)
    script = (
        "import json, sys, types, torch\n"
        "from perfbench import harness\n"
        "e, c, cfg, m = harness.load_cell('toy.rows')\n"
        "p = harness.load_program(cfg)\n"
        "p.check(cfg)\n"
        "for trace in (0, 1):\n"
        "    a = types.SimpleNamespace(workload='toy.rows', seed=5,\n"
        "                              seconds=0.2, trace=trace)\n"
        "    r = harness.measure(a, e, c, cfg, m, torch.device('cpu'), p)\n"
        "    print(json.dumps(harness.result_line(\n"
        "        r, torch.device('cpu'), 1, trace)))\n"
        "from perfbench import calibrate\n"
        "a = types.SimpleNamespace(seeds=2, controls=0, units=5,\n"
        "                          seconds=0.2, first_seed=7)\n"
        "print(json.dumps(calibrate.readings((a, e, c, cfg),\n"
        "                                    torch.device('cpu'), p)))\n")
    r = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    out = [json.loads(x) for x in r.stdout.strip().splitlines()]
    plain, traced, calibrated = out[0], out[1], out[-1]
    for line in (plain, traced):
        assert line["correct"], line["checks"]
    assert set(plain["metrics"]) == {"toy_rows_per_s", "setup_s",
                                     "peak_mem_gib"}
    assert set(traced["metrics"]) == {"toy_unit_ms"}
    # Calibration asks the traffic, not its name, whether its check holds
    # a unit: it runs up to that unit (2), not --units (5).
    assert [(x["side"], x["units"]) for x in calibrated] == [
        ("program", 2), ("program", 2)]
    assert all(x["out_gap"] <= 1e-5 for x in calibrated)
    after = digest(tmp_path / "perfbench")
    assert {k: after[k] for k in before} == before
