"""The port's study scripts (gantron_tpu_torch/scripts/) against the JAX
package's (scripts/, loaded by path: they import JAX only inside ``main``).

* ``run_study``: ``known_arms()``, ``NAMED_ARMS`` and ``merge_hparams``
  equal the JAX runner's; the counterparts of tests/test_study_runner.py's
  cases (a malformed ``--queue`` exits 2, ``--list`` runs clean and lists
  the JAX runner's arms, a stale ``STOP`` file is consumed, a ``STOP``
  file stops the queue with exit 3) and the refusal of two studies in one
  ``-o``.
* Every study's ``VARIANTS`` (``_BIT_WARM``, ``_WARM`` and the sweep
  constants) equal the JAX script's, and for every study x variant the
  port's assembled ``HParams`` equal the JAX script's assembly
  (``gantron_tpu.config.HParams`` + ``small_model_params`` + the study's
  fields + variant + ``--hparams``) field by field.
* ``evidence_run``'s ``mel_sharpness`` and ``kmeans_on_study`` on one
  ``.npy`` directory equal JAX's, and ``alignment_check`` on weights
  carried from JAX (``tacotron2_from_jax``), dropout off on both sides,
  within rtol 1e-5.
"""

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch

import gantron_tpu.models.tacotron2 as jax_taco
from gantron_tpu.config import HParams as JaxHParams
from gantron_tpu_torch.eval import clustering as port_clustering
from gantron_tpu_torch.scripts import run_study
from test_torch_conditioned import CONFIGS, init_jax_weights
from test_torch_tacotron2 import (no_jax_dropout,  # noqa: F401
                                  port_model, tiny_hparams)
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPTS = os.path.join(REPO, "scripts")
STUDIES = ["gan_mode_study", "gan_texture_study", "gan_composed_study",
           "gan_factorial_study", "gan_continuous_study", "gan_vector_study",
           "evidence_run"]
# Each study's own fields over small_model_params, as its JAX main() adds
# them (the seed offsets at gan_mode_study.py:172, gan_texture_study.py:98,
# gan_composed_study.py:114, gan_factorial_study.py:187,
# gan_continuous_study.py:121, gan_vector_study.py:127; the labels of
# evidence_run.py:180-185).
SEED_BASE = {"gan_mode_study": 1234, "gan_texture_study": 4321,
             "gan_composed_study": 4321, "gan_factorial_study": 5321,
             "gan_continuous_study": 5321, "gan_vector_study": 6321}
OVERRIDE = "discriminator_dim=48,diversity_cap=0.45"


def jax_script(name):
    """The JAX package's scripts/<name>.py as a module (its main not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", os.path.join(JAX_SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_script(name):
    return importlib.import_module(f"gantron_tpu_torch.scripts.{name}")


def run_cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "gantron_tpu_torch.scripts.run_study", *args],
        capture_output=True, text=True, cwd=cwd, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))


def test_runner_arms_and_merge_equal_jax():
    jax_runner = jax_script("run_study")
    assert run_study.known_arms() == jax_runner.known_arms()
    assert run_study.NAMED_ARMS == jax_runner.NAMED_ARMS
    assert list(run_study.STUDIES) == list(jax_runner.STUDIES)
    for extra, user in ((["--hparams", "diversity_cap=0.45"],
                         "seed_offset=1"),
                        (["--hparams", "diversity_cap=0.45"], None),
                        ([], "a=1"), (["--iterations", "9000"], "a=1")):
        assert run_study.merge_hparams(extra, user) \
            == jax_runner.merge_hparams(extra, user)


@pytest.mark.parametrize("spec", ["continuous/cont_warm", "noseed:",
                                  ":3", "continuous/cont_warm:x"])
def test_malformed_queue_spec_rejected(spec):
    r = run_cli("--queue", spec)
    assert r.returncode == 2  # argparse error, not a silent skip
    assert "malformed" in r.stderr or "unknown arm" in r.stderr


def test_list_runs_clean_with_the_jax_arms():
    r = run_cli("--list")
    assert r.returncode == 0, r.stderr
    j = subprocess.run([sys.executable,
                        os.path.join(JAX_SCRIPTS, "run_study.py"), "--list"],
                       capture_output=True, text=True, timeout=120)
    assert [line.split()[0] for line in r.stdout.splitlines()] \
        == [line.split()[0] for line in j.stdout.splitlines()]
    assert "-m gantron_tpu_torch.scripts.gan_continuous_study" in r.stdout


def test_two_studies_may_not_share_one_root(tmp_path):
    r = run_cli("--queue", "mode/gan:0", "continuous/cont_warm:0",
                "-o", str(tmp_path))
    assert r.returncode == 2
    assert "would share the corpus" in r.stderr


def test_stale_stop_file_is_consumed(tmp_path):
    """A STOP file left from an earlier queue is removed before the arm
    starts (here an arm that exits at once, on an unknown argument), so
    the run is no silent no-op."""
    (tmp_path / "STOP").write_text("")
    r = run_cli("--arm", "mode/gan", "-o", str(tmp_path), "--device", "cpu",
                "--study_args=--no_such_flag", cwd=str(tmp_path))
    assert f"removed stale stop-file {tmp_path / 'STOP'}" in r.stdout
    assert not (tmp_path / "STOP").exists()
    assert r.returncode == 1  # the arm itself failed
    log = (tmp_path / "progress.log").read_text()
    assert "-m gantron_tpu_torch.scripts.gan_mode_study --variant gan " \
        "--seed 0" in log and "--device cpu --no_such_flag" in log
    assert "=== rc=2" in log


def test_stop_file_ends_the_queue(tmp_path, monkeypatch):
    """A STOP file touched while an arm runs lets it finish and starts no
    other: exit 3, the log says so, the arms after it never start."""
    started = []

    def arm(cmd, **kw):
        started.append(cmd[cmd.index("--seed") + 1])
        (tmp_path / "STOP").write_text("")
        return 0

    monkeypatch.setattr(run_study.subprocess, "call", arm)
    rc = run_study.main(["--queue", "mode/gan:0", "mode/gan:1",
                         "mode/gan:2", "-o", str(tmp_path)])
    assert rc == 3 and started == ["0"]
    assert f"=== STOPPED by {tmp_path / 'STOP'}" in \
        (tmp_path / "progress.log").read_text()


@pytest.mark.parametrize("name", STUDIES)
def test_variants_equal_jax(name):
    port, jax = port_script(name), jax_script(name)
    assert port.VARIANTS == jax.VARIANTS
    assert list(port.VARIANTS) == list(jax.VARIANTS)
    for const in ("_BIT_WARM", "_WARM", "N_CODES", "CODE_LO", "CODE_HI",
                  "BAND_NAMES", "TARGET_FRACS"):
        if hasattr(jax, const):
            assert getattr(port, const) == getattr(jax, const), const


def test_study_common_equals_jax():
    port, jax = port_script("_study_common"), jax_script("_study_common")
    for it in (1, 2, 8, 3000):
        assert port.small_model_params(it) == jax.small_model_params(it)
    assert port.STUDY_TEXT == jax_script("gan_mode_study").STUDY_TEXT


def jax_assembly(name, variant, seed, train, val, hparams):
    """The JAX script's HParams assembly, as its main() runs it."""
    common = jax_script("_study_common")
    hp = JaxHParams()
    hp.add_params(common.small_model_params(8))
    if name == "evidence_run":
        hp.add_params(dict(
            speakers_embedding=16, n_labels=5, use_noise=False, noise_size=0,
            use_labels=True, use_intended_labels=True, vesus_path="vesus/",
            training_files=["lj_empty.txt", train],
            validation_files=["lj_empty.txt", val]))
    else:
        hp.add_params(dict(use_noise=True, noise_size=32, use_labels=False,
                           seed=SEED_BASE[name] + seed,
                           training_files=[train], validation_files=[val]))
    hp.add_params(jax_script(name).VARIANTS[variant])
    hp.add_params_string(hparams)
    return hp


@pytest.mark.parametrize("name,variant", [
    (n, v) for n in STUDIES for v in jax_script(n).VARIANTS])
def test_assembled_hparams_equal_jax(name, variant):
    seed = 0 if name == "evidence_run" else 2
    args = argparse.Namespace(variant=variant, seed=seed, iterations=8,
                              hparams=OVERRIDE)
    mod = port_script(name)
    if name == "evidence_run":
        hp = mod.hparams_for(args, "vesus/", "lj_empty.txt", "train.txt",
                             "val.txt")
    else:
        hp = mod.hparams_for(args, "train.txt", "val.txt")
    want = jax_assembly(name, variant, seed, "train.txt", "val.txt",
                        OVERRIDE).as_dict()
    got = hp.as_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == v, k


def write_group_mels(root, seed=0):
    """'{g}-{i}-x.npy' mels of 3 groups (80 bins, 20-29 frames), each group
    lifting its own band; some with a leading batch axis, as the study
    writes them."""
    rng = np.random.RandomState(seed)
    for g in range(3):
        for i in range(5):
            mel = rng.randn(80, rng.randint(20, 30)).astype(np.float32) - 6
            mel[g * 25:(g + 1) * 25] += 8
            np.save(os.path.join(root, f"{g}-{i}-x.npy"),
                    mel[None] if i % 2 else mel)


def test_mel_sharpness_and_kmeans_equal_jax(tmp_path, monkeypatch):
    """On one directory: mel_sharpness equal; kmeans_on_study equal with
    the port's k-means given sklearn's clusters (the port's own k-means is
    held to sklearn's in tests/test_torch_clustering.py), and with the
    port's own clusters every permutation-free field equal."""
    pytest.importorskip("sklearn")
    from sklearn.cluster import KMeans

    write_group_mels(str(tmp_path))
    port, jax = port_script("evidence_run"), jax_script("evidence_run")
    assert port.mel_sharpness(str(tmp_path)) \
        == jax.mel_sharpness(str(tmp_path))
    want = jax.kmeans_on_study(str(tmp_path))
    own = port.kmeans_on_study(str(tmp_path), device="cpu")
    assert {k: v for k, v in own.items() if k != "basic_accuracy"} \
        == {k: v for k, v in want.items() if k != "basic_accuracy"}
    assert want["best_accuracy"] == 1.0

    def sklearn_kmeans(data, k, n_init, seed, device):
        return KMeans(n_clusters=k, random_state=seed,
                      n_init=n_init).fit(data)

    monkeypatch.setattr(port_clustering, "kmeans", sklearn_kmeans)
    assert port.kmeans_on_study(str(tmp_path), device="cpu") == want


def test_alignment_check_matches_jax(no_jax_dropout):  # noqa: F811
    """A labels-conditioned tiny model with JAX's weights, prenet dropout
    off on both sides and the gate never firing (threshold 1): focus,
    monotonicity and coverage of every decode within rtol 1e-5."""
    jhp, hp = tiny_hparams(**CONFIGS["labels"])
    jhp.gate_threshold = hp.gate_threshold = 1.0
    variables = init_jax_weights(jhp)
    model = jax_taco.Tacotron2(jhp)
    port = port_model(variables, hp)
    want = jax_script("evidence_run").alignment_check(
        model, variables, jhp, "aeioumnst", n_groups=2, batch=2)
    with torch.no_grad():
        got = port_script("evidence_run").alignment_check(
            port, hp, "aeioumnst", n_groups=2, batch=2)
    assert got.keys() == want.keys() and got["n"] == want["n"] == 4
    for k in ("focus", "monotonicity", "coverage"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert json.dumps(got)  # plain numbers
