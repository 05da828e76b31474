"""BENCHMARK.json against the benchmark's contract and its own files:
every entry resolves to its file by name, names and units use the allowed
characters, every per-layer metric's cells report the end-to-end metric it
moves, and the run length fits the full check."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load(rel):
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        return json.load(f)


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(m["command"]) <= 32
    assert all(one_line(w) and not w.startswith("/") and ".." not in w
               for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # A full check of 24 cells: 2 + 14 * 24 runs of run_seconds + 60, 2 x 90
    # a cell to compile, 1200 spare, within 43200 seconds.
    s = m["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_entries_have_the_contracts_keys_and_names(section):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[section]
    entries = manifest()[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for k in ("why", "layer", "source"):
            if k in e and section != "end_to_end" and section != "per_layer":
                assert one_line(e[k]), (e["name"], k)
        if section == "per_layer":
            assert one_line(e["layer"])


def test_every_entry_resolves_to_its_files_by_name():
    m = manifest()
    configs = {c["name"]: c for c in m["configs"]}
    used = set()
    for c in m["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        cfg = load(c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert NAME.match(cfg["program"]) and os.path.exists(os.path.join(
            ROOT, "perfbench", "programs", cfg["program"] + ".py"))
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files)
    pairs = set()
    for w in m["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert one_line(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = load(f"perfbench/workloads/{w['name']}.json")
        assert (cell["name"], cell["config"], cell["traffic"]) == (
            w["name"], w["config"], w["traffic"])
        assert cell["why"] == w["why"]
        assert os.path.exists(os.path.join(
            ROOT, "perfbench", "traffic", w["traffic"] + ".py"))
        used.add(w["config"])
    assert used == set(configs)
    for metric in m["per_layer"]:
        assert os.path.exists(os.path.join(
            ROOT, "perfbench", "metrics", metric["name"] + ".py"))
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(
        1, len(m["workloads"]) // 4)


def test_metric_sources_and_bounds():
    m = manifest()
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert e["moves"] in e2e
        if e["name"].endswith("_roofline") or "mfu" in e["name"]:
            assert e["unit"] == "%"


def cells_reporting(entry, cells):
    return entry.get("workloads", cells)


def test_every_cell_reports_what_its_per_layer_metrics_move():
    m = manifest()
    cells = [w["name"] for w in m["workloads"]]
    e2e = {e["name"]: e for e in m["end_to_end"]}
    layers = {}
    for e in m["per_layer"]:
        layers.setdefault(e["layer"], set()).add(e["layer"])
        for cell in cells_reporting(e, cells):
            assert cell in cells
            assert cell in cells_reporting(e2e[e["moves"]], cells), (
                e["name"], cell)
    for cell in cells:
        reported = [n for n, e in e2e.items()
                    if cell in cells_reporting(e, cells)]
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert any(cell in cells_reporting(e, cells)
                   for e in m["per_layer"]), cell
    # A step's share of the peak moves every metric a kernel's roofline
    # moves, in the same cells.
    for e in m["per_layer"]:
        if e["name"].endswith("_roofline"):
            assert any("mfu" in f["name"] and f["moves"] == e["moves"]
                       and set(cells_reporting(e, cells))
                       <= set(cells_reporting(f, cells))
                       for f in m["per_layer"])


WIDTH = re.compile(r"(_dim|_rank|_size|embedding|channels|heads|hidden|"
                   r"intermediate|latent|state|projection|expansion)")


def test_no_width_is_reduced_and_widths_are_the_programs_defaults():
    from perfbench.tests.tiny import adapter

    for c in manifest()["configs"]:
        cfg = load(c["file"])
        defaults = adapter(cfg).defaults()
        assert not any(WIDTH.search(k) for k in cfg["reduced"])
        for key, value in cfg["model"].items():
            if key in defaults and key not in cfg["reduced"] \
                    and key not in ("use_labels", "use_noise"):
                assert defaults[key] == value, (c["name"], key)
