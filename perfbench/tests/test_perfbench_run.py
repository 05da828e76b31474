"""The entry point as the check runs it: no card, no result; a directory
with only the benchmark, no result; JAX loaded, no result; and, on a
card, one short run of a cell that comes out correct."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from perfbench import harness
from perfbench.tests.tiny import cells

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(cwd, seconds="1", env=None, cell=None):
    cell = cell or cells("synth_batch")[0]
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 5), "--seconds", seconds, "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, **(env or {})))


def test_without_a_card_it_exits_nonzero_and_prints_nothing():
    r = run(ROOT, env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA card" in r.stderr


def test_in_a_directory_with_only_the_benchmark_it_prints_nothing(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run(tmp_path)
    assert r.returncode != 0 and r.stdout == ""
    assert "gantron_tpu_torch" in r.stderr


def test_jax_in_the_process_is_found_by_its_top_level_name(monkeypatch):
    import gantron_tpu_torch  # noqa: F401  the port: a name of its own

    monkeypatch.setitem(sys.modules, "gantron_tpu.config",
                        types.ModuleType("gantron_tpu.config"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("jaxlib.xla_client"))
    found = harness.forbidden_modules()
    assert {"gantron_tpu", "jaxlib"} <= set(found)
    assert "gantron_tpu_torch" not in found


def test_a_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    r = run(ROOT, seconds="3")
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
