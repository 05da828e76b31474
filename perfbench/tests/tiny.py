"""Tiny configurations and cells for the CPU tests: the benchmark's own
files with every width cut as the configuration's adapter says, so that a
whole run (set-up, window, check) takes seconds on the CPU."""

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def manifest():
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        return json.load(f)


def cells(traffic=None, chips=None):
    """BENCHMARK.json's cells, or those of one traffic kind, or on so many
    cards."""
    return [w["name"] for w in manifest()["workloads"]
            if traffic in (None, w["traffic"]) and chips in (None, w["chips"])]


def load(kind, name):
    with open(os.path.join(HERE, kind, name + ".json"),
              encoding="utf-8") as f:
        return json.load(f)


def adapter(cfg):
    """The configuration's program adapter (``perfbench/programs/``)."""
    from perfbench import harness

    return harness.load_program(cfg)


def tiny(cell_name, m=None, **params):
    """(manifest entry, cell, cfg, manifest) of a cell of ``m`` (by default
    BENCHMARK.json) at the tiny widths of its configuration's adapter
    (``TINY``)."""
    m = m or manifest()
    entry = next(w for w in m["workloads"] if w["name"] == cell_name)
    cell = copy.deepcopy(load("workloads", cell_name))
    cfg = copy.deepcopy(load("configs", entry["config"]))
    for section, cut in adapter(cfg).TINY.items():
        cfg[section].update(cut)
    cell["params"].update(params)
    return entry, cell, cfg, m
