"""Port parity: gantron_tpu_torch's training loop, checkpoints, logger and
training CLI against the JAX package's (gantron_tpu/train/loop.py,
train/checkpoint.py, utils/logging.py, train.py).

The two loops run on the synthetic corpus at test_loop's tiny shapes from
one initial state: the JAX loop builds its own, and the port's
``create_train_state`` is patched to return that state carried over by
``utils/jax_weights.train_state_from_jax``. Dropout is off on both sides (the
JAX modules' ``_dropout`` monkeypatched, the port's ``disable_dropout``) and
``use_noise=False``, so neither side draws anything random; both run in
float32. Each JAX loop runs once per module (fixtures).
"""

import functools
import json
import os
import shutil

import numpy as np
import pytest

import jax
import torch

import gantron_tpu.models.discriminator as jax_disc
import gantron_tpu.models.tacotron2 as jax_taco
import gantron_tpu.train.loop as jax_loop
from gantron_tpu.train.checkpoint import CheckpointManager as JaxCkpt
from gantron_tpu.train.state import create_train_state as jax_create_state
from gantron_tpu.utils.logging import MetricLogger as JaxLogger
from gantron_tpu_torch.config import HParams
from gantron_tpu_torch.models.modules import disable_dropout
from gantron_tpu_torch.train import loop
from gantron_tpu_torch.train.checkpoint import CheckpointManager
from gantron_tpu_torch.train.step import make_train_steps
from gantron_tpu_torch.utils.jax_weights import train_state_from_jax
from gantron_tpu_torch.utils.logging import MetricLogger
from test_loop import tiny_hp as jax_tiny_hp
from torch_threads import one_torch_thread  # noqa: F401

# Per-iteration logged losses, port against JAX, relative to each value
# (with a floor of 1e-3 for values near 0, such as the adversarial and
# discriminator losses): one step agrees to ~1e-5 (test_torch_train.py);
# over 12 steps Adam carries float32 rounding differences of the
# gradients forward; the worst measured here is 1.6e-4 (an adversarial
# loss near 0, against the floor).
LOSS_RTOL, LOSS_FLOOR = 1e-3, 1e-3
# Validation losses, relative: ``validate`` on the same weights agrees to
# VAL_TOL. Through the loop it cannot: the conv biases before a
# training-mode BatchNorm have a gradient of exactly 0, which both sides
# compute as float32 noise that Adam scales up to the learning rate
# (train/state.py BN_FED_BIAS), so after training those biases, and the
# BatchNorm running means that track them, differ between the two runs by
# ~1e-3. Training losses cannot see it (batch statistics remove the
# bias); validation, on running statistics, does. Measured on this run:
# 1.2e-5 (mel) and 1.7e-4 (gate) after 12 steps; after 6, 1.5e-5 and
# 1.3e-4, and 2e-8 / 2.3e-7 once the port's BN-fed biases and running
# statistics are replaced by JAX's.
VAL_TOL, VAL_LOOP_TOL = 1e-5, 1e-3
# The run: the G warm-up (0-5), the D-only phase (6-8), the G/G/D
# alternation (9-11), the attention weight switched off at 4, the learning
# rates halved at 5 and 10, and validation, with Griffin-Lim audio, and a
# checkpoint at 12, where the checkpoint interval and the stop coincide
# (validated once).
RUN = dict(noise_size=0, use_noise=False, iterations=12,
           iters_per_checkpoint=12, disc_warmp_up=8, attn_steps=4,
           reduce_lr_steps_every=5, validation_audio=True)
SKIP_KEYS = ("time", "Generation duration", "Discriminator duration",
             "Data duration", "Validation duration", "Checkpoint duration")


def port_hp(jhp):
    hp = HParams()
    hp.add_params(jhp.as_dict())
    return hp


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def records(path):
    """step -> {key: value} of a metrics JSONL, durations and times left
    out."""
    out = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            step = r.pop("step")
            out.setdefault(step, {}).update(
                {k: v for k, v in r.items() if k not in SKIP_KEYS})
    return out


@functools.lru_cache(maxsize=None)
def jax_initial_state():
    """The state the JAX loop builds for itself at RUN's shapes (every run
    here has them): the same call on the same first batch, numpy leaves."""
    jhp = jax_tiny_hp(**RUN)
    train_loader, _ = jax_loop.prepare_dataloaders(jhp, "synthetic")
    sample = next(iter(train_loader))
    return np_tree(jax_create_state(jhp, jax.random.PRNGKey(jhp.seed),
                                    tuple(sample))[0])


def patch_port_state(monkeypatch):
    """The port loop starts from the JAX loop's initial state, dropout
    off."""
    jax_state = jax_initial_state()

    def create(hp, seed, sample, device):
        state, G, D, g_tx, d_tx = train_state_from_jax(jax_state, hp,
                                                       device="cpu")
        disable_dropout(G)
        disable_dropout(D)
        return state, G, D, g_tx, d_tx

    monkeypatch.setattr(loop, "create_train_state", create)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX loop and the port's loop, 12 iterations each, from one
    state, dropout off on both; returns their output directories and
    hparams."""
    root = tmp_path_factory.mktemp("loops")
    jhp = jax_tiny_hp(**RUN)
    hp = port_hp(jhp)
    dirs = {"jax": str(root / "jax"), "port": str(root / "port")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_taco, "_dropout", lambda x, r, k: x)
        mp.setattr(jax_disc, "_dropout", lambda x, r, k: x)
        j_state, j_it = jax_loop.train(
            dirs["jax"], None, False, jhp, "synthetic",
            logger=JaxLogger(dirs["jax"], run_name="m", quiet=True))
        patch_port_state(mp)
        p_state, p_it = loop.train(
            dirs["port"], None, False, hp, "synthetic",
            logger=MetricLogger(dirs["port"], run_name="m", quiet=True),
            device="cpu")
    return dict(dirs=dirs, jhp=jhp, hp=hp, iterations=(j_it, p_it),
                steps=(int(np.asarray(j_state.step)), p_state.step),
                j_state=np_tree(j_state))


def assert_runs_match(j_recs, p_recs, steps):
    for step in steps:
        j, p = j_recs[step], p_recs[step]
        assert sorted(p) == sorted(j), (step, sorted(p), sorted(j))
        for k, jv in j.items():
            tol = (VAL_LOOP_TOL * abs(jv) if k.startswith("Validation")
                   else LOSS_RTOL * max(abs(jv), LOSS_FLOOR))
            assert abs(p[k] - jv) <= tol, (step, k, p[k], jv)


def test_loop_matches_jax(runs):
    """The same G/D sequence (each step logs generator or discriminator
    keys), the same learning rates, the attention loss logged exactly while
    its weight is 10, per-iteration losses within LOSS_RTOL and validation
    losses within VAL_LOOP_TOL."""
    assert runs["iterations"] == (12, 12) and runs["steps"] == (12, 12)
    j = records(os.path.join(runs["dirs"]["jax"], "m.metrics.jsonl"))
    p = records(os.path.join(runs["dirs"]["port"], "m.metrics.jsonl"))
    assert sorted(p) == sorted(j) == list(range(13))
    kinds = ["D" if "Discriminator loss" in p[s] else "G" for s in range(12)]
    assert "".join(kinds) == "GGGGGGDDDGGD"
    assert [s for s in range(12) if "Attention loss" in p[s]] == \
        [0, 1, 2, 3]
    assert [p[s].get("Generator learning rate",
                     p[s].get("Discriminator learning rate"))
            for s in (4, 5, 6, 9, 10)] == [1e-3, 5e-4, 3.5e-4, 5e-4, 2.5e-4]
    assert_runs_match(j, p, range(13))
    # The checkpoints on disk: the same iterations (one at 12), and losses
    # (mel + gate validation loss, rounded to 6 decimals in the name) within
    # VAL_LOOP_TOL.
    names = {side: sorted(CheckpointManager.parse_name(n) for n in
                          os.listdir(d) if n.endswith(".ckpt"))
             for side, d in runs["dirs"].items()}
    assert [i for i, _ in names["port"]] == [i for i, _ in names["jax"]] \
        == [12]
    for (_, pv), (_, jv) in zip(names["port"], names["jax"]):
        assert abs(pv - jv) <= VAL_LOOP_TOL * abs(jv)


def test_validate_matches_jax_on_the_same_weights(runs, tmp_path):
    """The port's ``validate`` on the state the JAX loop ended with (its
    generator seeded per batch from seed and iteration, dropout off) gives
    the validation losses JAX logged at iteration 12 within VAL_TOL, the
    attention loss zeroed past attn_steps, and mel + gate as its result."""
    hp = runs["hp"]
    state, G, D, g_tx, d_tx = train_state_from_jax(runs["j_state"], hp,
                                                   device="cpu")
    disable_dropout(G)
    _, _, eval_step = make_train_steps(hp, G, D, g_tx, d_tx)
    _, val_loader = loop.prepare_dataloaders(hp, "synthetic", "cpu")
    logger = MetricLogger(str(tmp_path), run_name="v", quiet=True)
    val_loss = loop.validate(eval_step, state, val_loader, 12, hp, logger,
                             hp.attn_steps)
    logger.close()
    got = records(str(tmp_path / "v.metrics.jsonl"))[12]
    want = records(os.path.join(runs["dirs"]["jax"], "m.metrics.jsonl"))[12]
    assert sorted(got) == ["Validation attention loss", "Validation gate loss",
                           "Validation mel loss"]
    assert got["Validation attention loss"] == 0.0
    for k, v in got.items():
        assert abs(v - want[k]) <= VAL_TOL * abs(want[k]), (k, v, want[k])
    assert val_loss == got["Validation mel loss"] + got["Validation gate loss"]


def test_validation_audio_matches_jax_media(runs):
    """Validation audio through Griffin-Lim: the port writes the JAX loop's
    media files (the same three samples of the last batch, plots and wavs),
    each wav as long as JAX's."""
    from gantron_tpu_torch.data.wav import read_wav

    media = {side: os.path.join(d, "media")
             for side, d in runs["dirs"].items()}
    names = sorted(os.listdir(media["jax"]))
    assert sorted(os.listdir(media["port"])) == names
    wavs = [n for n in names if n.endswith(".wav")]
    assert len(wavs) == 3 and len(names) == 12
    for n in wavs:
        pw, pr = read_wav(os.path.join(media["port"], n))
        jw, jr = read_wav(os.path.join(media["jax"], n))
        assert pr == jr and pw.shape == jw.shape and np.isfinite(pw).all()
        assert np.abs(pw).max() > 0


RESUME = dict(RUN, iterations=16, use_saved_learning_rate=True,
              validation_audio=False)


def resume_dir(runs, side, tmp):
    """A copy of a fixture run's output directory whose newest checkpoint
    (iteration 12) carries an off-schedule g_lr in its sidecar; returns the
    directory and that checkpoint."""
    d = str(tmp / side)
    shutil.copytree(runs["dirs"][side], d)
    latest = (JaxCkpt if side == "jax" else CheckpointManager)(d).latest()
    assert CheckpointManager.parse_name(latest)[0] == 12
    with open(latest + ".meta.json") as f:
        meta = json.load(f)
    meta["g_lr"] = 3.21e-4
    with open(latest + ".meta.json", "w") as f:
        json.dump(meta, f)
    return d, latest


@pytest.fixture(scope="module")
def jax_resumed(runs, tmp_path_factory):
    """The JAX loop rerun in a copy of its output directory to iteration
    16: it auto-resumes from its iteration-12 checkpoint."""
    d, _ = resume_dir(runs, "jax", tmp_path_factory.mktemp("resume"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_taco, "_dropout", lambda x, r, k: x)
        mp.setattr(jax_disc, "_dropout", lambda x, r, k: x)
        _, it = jax_loop.train(d, None, False, jax_tiny_hp(**RESUME),
                               "synthetic",
                               logger=JaxLogger(d, run_name="r", quiet=True))
    return it, records(os.path.join(d, "r.metrics.jsonl"))


@pytest.mark.parametrize("mode", ["auto", "explicit"])
def test_resume_with_saved_lr_matches_jax(runs, jax_resumed, tmp_path,
                                          monkeypatch, mode):
    """The port's rerun resumes at iteration 12 (no +1) from its newest
    checkpoint, found by itself (auto) or given (explicit), with the
    learning rates of its sidecar (use_saved_learning_rate; an off-schedule
    g_lr here) and an empty fake buffer: the same G/D sequence, learning
    rates and losses as the JAX loop's auto-resumed run."""
    d, latest = resume_dir(runs, "port", tmp_path)
    jhp = jax_tiny_hp(**RESUME)
    patch_port_state(monkeypatch)  # dropout off; weights from the ckpt
    _, it = loop.train(d, latest if mode == "explicit" else None, False,
                       port_hp(jhp), "synthetic",
                       logger=MetricLogger(d, run_name="r", quiet=True),
                       device="cpu")
    j_it, j = jax_resumed
    p = records(os.path.join(d, "r.metrics.jsonl"))
    assert it == j_it == 16
    assert sorted(p) == sorted(j) == [12, 13, 14, 15, 16]
    g = [s for s in range(12, 16) if "Generator loss" in p[s]]
    assert g and p[g[0]]["Generator learning rate"] == 3.21e-4
    assert_runs_match(j, p, range(12, 17))


def test_warm_start_takes_generator_weights_only(runs, tmp_path,
                                                 monkeypatch):
    """``warm_start=True`` with a checkpoint starts at iteration 0 with
    fresh Adam states and schedule (the JAX loop's warm start) and the
    checkpoint's generator weights by name, the layers of the default
    ignore_layers (both decoder LSTMs, the memory, projection and gate
    weights) fresh. A learning rate of 0 keeps the one G step from moving
    them."""
    src = CheckpointManager(runs["dirs"]["port"]).latest()
    jhp = jax_tiny_hp(**dict(RUN, iterations=1, g_learning_rate=0.0,
                             validation_audio=False))
    patch_port_state(monkeypatch)
    state, it = loop.train(str(tmp_path), src, True, port_hp(jhp),
                           "synthetic",
                           logger=MetricLogger(None, quiet=True),
                           device="cpu")
    assert it == 1 and state.step == 1 and state.g_opt_state.count == 1
    assert state.d_opt_state.count == 0
    saved = torch.load(src, weights_only=True)["g_state"]
    fresh = train_state_from_jax(jax_initial_state(), port_hp(jhp),
                                 device="cpu")[1].state_dict()
    ignored = ("decoder.attention_rnn.", "decoder.decoder_rnn.",
               "decoder.memory_w", "decoder.proj_w", "decoder.gate_w")
    for k, v in state.g_model.named_parameters():
        want = fresh[k] if k.startswith(ignored) else saved[k]
        assert torch.equal(v.detach(), want), k
    assert not torch.equal(saved["embedding"], fresh["embedding"])
    assert not torch.equal(saved["decoder.proj_w"], fresh["decoder.proj_w"])
