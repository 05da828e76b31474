"""Port parity of the training loop's parts that need no full training run
(split from tests/test_torch_loop.py so that parallel test workers can run
them beside it): the G/D schedule, checkpoints (round trip, retention,
warm-start merge), the loop's guards and refusals, the metric logger, the
rescue controllers and ``max_seconds``, each against the JAX package's
(gantron_tpu/train/loop.py, train/checkpoint.py, utils/logging.py).
"""

import json
import os
import re

import numpy as np
import pytest

import jax
import torch

import gantron_tpu.models.discriminator as jax_disc
import gantron_tpu.models.tacotron2 as jax_taco
import gantron_tpu.train.loop as jax_loop
from gantron_tpu.train.checkpoint import CheckpointManager as JaxCkpt
from gantron_tpu.train.checkpoint import warm_start_filter as jax_warm_start
from gantron_tpu.utils.logging import MetricLogger as JaxLogger
from gantron_tpu_torch.config import HParams
from gantron_tpu_torch.train import loop
from gantron_tpu_torch.train.checkpoint import (CheckpointManager,
                                                warm_start_filter)
from gantron_tpu_torch.train.state import create_train_state
from gantron_tpu_torch.train.step import make_train_steps, to_device
from gantron_tpu_torch.utils.jax_weights import tacotron2_from_jax
from gantron_tpu_torch.utils.logging import MetricLogger
from test_loop import tiny_hp as jax_tiny_hp
from test_torch_loop import RUN, np_tree, patch_port_state, port_hp
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("g_freq,d_freq", [(2, 1), (1, 1), (3, 2), (2, 0),
                                           (1, 3)])
@pytest.mark.parametrize("warm_up", [0, 8, 500, 12000])
def test_schedule_matches_jax(g_freq, d_freq, warm_up):
    """is_disc_turn/advance_counters against the JAX package's over 25,000
    iterations (two discriminator bursts at 10k and 20k), with the fake
    buffer filled as the loop fills it."""
    hp = HParams()
    hp.add_params(dict(g_freq=g_freq, d_freq=d_freq, disc_warmp_up=warm_up))
    seqs = []
    for turn, advance in ((jax_loop.is_disc_turn, jax_loop.advance_counters),
                          (loop.is_disc_turn, loop.advance_counters)):
        gen, disc, buf, seq = 1, 0, 0, []
        for it in range(25000):
            d = turn(it, gen, disc, hp, buf)
            if not d:
                buf = min(buf + 1, max(d_freq, 1))
            gen, disc = advance(d, it, gen, disc, hp)
            seq.append(d)
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert any(seqs[1]) == (d_freq > 0)


def small_state(seed=0, steps=True):
    """A port training state at the tiny shapes, after one G and one D
    step when ``steps`` (non-zero Adam moments, advanced generators)."""
    jhp = jax_tiny_hp(batch_size=2)
    hp = port_hp(jhp)
    train_loader, _ = loop.prepare_dataloaders(hp, "synthetic", "cpu")
    batch = next(iter(train_loader))
    state, G, D, g_tx, d_tx = create_train_state(hp, seed, batch, "cpu")
    if steps:
        g_step, d_step, _ = make_train_steps(hp, G, D, g_tx, d_tx)
        b = to_device(batch, "cpu")
        state, _, (mel, lens) = g_step(state, b, 1e-3, 10.0)
        state, _ = d_step(state, b.mels, b.output_lengths, mel, lens, 1e-3)
    return state


def assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in ((a.g_model, b.g_model), (a.d_model, b.d_model)):
        sx, sy = x.state_dict(), y.state_dict()
        assert list(sx) == list(sy)
        for k in sx:
            assert torch.equal(sx[k], sy[k]), k
    for x, y in ((a.g_opt_state, b.g_opt_state),
                 (a.d_opt_state, b.d_opt_state)):
        assert x.count == y.count
        for m, n in zip(x.mu + x.nu, y.mu + y.nu):
            assert torch.equal(m, n)
    for g in ("dropout_generator", "noise_generator"):
        assert torch.equal(getattr(a, g).get_state(),
                           getattr(b, g).get_state())


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    """restore(save(state)) into a state from another seed equals the saved
    state bit for bit: both models with G's BatchNorm statistics, both Adam
    states, the step and both generators; the payload reads back with
    weights_only. The JAX package's restore is held to the same rule on a
    tree of the same kinds of leaves."""
    state = small_state()
    ckpt = CheckpointManager(str(tmp_path / "port"))
    path = ckpt.save(state, 2, 1.25, extra={"g_lr": 1e-3, "d_lr": 5e-4})
    assert os.path.basename(path) == "iter=2_val-loss=1.25.ckpt"
    assert CheckpointManager.load_meta(path) == {"g_lr": 1e-3, "d_lr": 5e-4}
    other = small_state(seed=7, steps=False)
    assert_states_equal(ckpt.restore(path, other), state)
    # Restored draws continue the saved stream.
    assert torch.equal(torch.rand(4, generator=other.dropout_generator),
                       torch.rand(4, generator=state.dropout_generator))

    tree = {"params": np.arange(6, dtype=np.float32).reshape(2, 3),
            "step": np.asarray(2, np.int32)}
    jckpt = JaxCkpt(str(tmp_path / "jax"))
    jpath = jckpt.save(tree, 2, 1.25, extra={"g_lr": 1e-3, "d_lr": 5e-4})
    assert os.path.basename(jpath) == os.path.basename(path)
    assert JaxCkpt.load_meta(jpath) == CheckpointManager.load_meta(path)
    back = jckpt.restore(jpath, jax.tree_util.tree_map(np.zeros_like, tree))
    assert all(np.array_equal(back[k], tree[k]) for k in tree)


@pytest.mark.parametrize("iters_losses", [
    [(6, 5.0), (12, 4.0), (18, 6.0), (24, 5.5), (30, 3.0), (36, 3.0)],
    [(10, 2.0), (20, 2.0), (30, 1.0), (40, 1.5), (50, 1.5), (60, 0.5)],
    [(5, 1.0), (10, 1.1), (15, 1.2), (20, 0.9), (25, 0.9)],
])
def test_retention_best_latest_match_jax(tmp_path, iters_losses):
    """Saving the same (iteration, val loss) sequence, the port and the JAX
    CheckpointManager keep the same files (sidecars included), and agree
    on best() (ties to the later iteration) and latest() after every
    save."""
    state = small_state(steps=False)
    tree = {"x": np.zeros(2, np.float32)}
    p, j = CheckpointManager(str(tmp_path / "p")), JaxCkpt(str(tmp_path / "j"))
    for it, v in iters_losses:
        extra = {"g_lr": 1e-3, "d_lr": 1e-3}
        p.save(state, it, v, extra=extra)
        j.save(tree, it, v, extra=extra)
        assert sorted(os.listdir(p.output_directory)) == \
            sorted(os.listdir(j.output_directory))
        for a, b in ((p.best(), j.best()), (p.latest(), j.latest())):
            assert os.path.basename(a) == os.path.basename(b)
        assert CheckpointManager.parse_name(p.best()) == \
            JaxCkpt.parse_name(j.best())


@pytest.mark.parametrize("ignore", [None, [], ["embedding.weight",
                                               "decoder.attention_rnn.weight_ih"]])
def test_warm_start_filter_matches_jax(ignore):
    """The port's name-wise merge against the JAX tree merge on the same
    weights: a checkpoint of another conditioning config (noise 8 against
    4: the memory-side layers change shape) into a fresh model, with the
    default ignore_layers (None), none, and a list that names an LSTM
    (skipped whole, as the JAX package skips its subtree). BatchNorm
    statistics merge too."""
    from test_torch_tacotron2 import tiny_hparams

    def jax_vars(noise, seed):
        jhp, hp = tiny_hparams(noise_size=noise)
        if ignore is not None:
            jhp.ignore_layers = hp.ignore_layers = ignore
        model = jax_taco.Tacotron2(jhp)
        v = np_tree(jax.jit(lambda rngs: model.init(
            rngs, np.ones((2, 8), np.int32), np.full((2,), 8, np.int32),
            np.zeros((2, jhp.n_mel_channels, 4), np.float32),
            np.zeros((2,), np.int32), np.zeros((2, 5), np.float32),
            np.full((2,), 4, np.int32), train=False))(
                {"params": jax.random.PRNGKey(seed),
                 "dropout": jax.random.PRNGKey(1),
                 "noise": jax.random.PRNGKey(2)}))
        rng = np.random.RandomState(seed)
        for part in ("encoder", "postnet"):  # distinct statistics
            for st in v["batch_stats"][part].values():
                st["bn"]["mean"] = rng.normal(0, 0.1, st["bn"]["mean"].shape) \
                    .astype(np.float32)
        return jhp, hp, v

    jhp, hp, new = jax_vars(8, 0)
    _, old_hp, old = jax_vars(4, 3)
    merged = {k: jax_warm_start(new[k], old[k], jhp.ignore_layers)
              for k in ("params", "batch_stats")}
    expected = tacotron2_from_jax(np_tree(merged["params"]),
                                  np_tree(merged["batch_stats"]), hp,
                                  device="cpu").state_dict()
    fresh = tacotron2_from_jax(new["params"], new["batch_stats"], hp,
                               device="cpu").state_dict()
    restored = tacotron2_from_jax(old["params"], old["batch_stats"], old_hp,
                                  device="cpu").state_dict()
    out = warm_start_filter(fresh, restored, hp.ignore_layers)
    assert list(out) == list(expected)
    skip = tuple(p for name, p in (
        ("embedding.weight", "embedding"),
        ("decoder.attention_rnn.weight_ih", "decoder.attention_rnn."),
        ("decoder.decoder_rnn.weight_ih", "decoder.decoder_rnn."),
        ("decoder.attention_layer.memory_layer.linear_layer.weight",
         "decoder.memory_w"),
        ("decoder.linear_projection.linear_layer.weight", "decoder.proj_w"),
        ("decoder.gate_layer.linear_layer.weight", "decoder.gate_w"))
        if name in hp.ignore_layers)
    for k in out:
        if LSTM_WEIGHT.search(k):
            # The JAX merge never restores these: it keys leaves by
            # ``p.key``/``p.idx``, and the fields of an LSTMParams
            # NamedTuple flatten to GetAttrKey, which has neither, so
            # w_ih, w_hh and b share one key and the bias (last) wins.
            # The port restores them by name.
            assert torch.equal(expected[k], fresh[k]), k
            take = (tuple(restored[k].shape) == tuple(fresh[k].shape)
                    and not k.startswith(skip))
            assert torch.equal(out[k], restored[k] if take else fresh[k]), k
        else:
            assert torch.equal(out[k], expected[k]), k
    taken = [k for k in out if torch.equal(out[k], restored.get(k, out[k]))
             and not torch.equal(out[k], fresh[k])]
    assert taken  # the merge took weights from the checkpoint


LSTM_WEIGHT = re.compile(r"\.(lstm_fw|lstm_bw|attention_rnn|decoder_rnn)"
                         r"\.w_(ih|hh)$")

GUARDS = [
    dict(diversity_rescue_floor=0.5),
    dict(diversity_rescue_ceiling=2.0, validation_sample_diversity=3),
    dict(factor_rescue_floor=2.0, style_code_dims=1),
    dict(factor_rescue_floor=2.0, style_code_dims=2),
    dict(factor_rescue_floor=2.0, style_code_dims=2,
         validation_sample_diversity=3),
]


@pytest.mark.parametrize("over", GUARDS)
def test_loop_guards_raise_as_jax(tmp_path, over):
    """The JAX loop's fail-fast guards raise the same ValueError in the
    port, before any data is read."""
    jhp = jax_tiny_hp(**over)
    with pytest.raises(ValueError) as j_err:
        jax_loop.train(str(tmp_path / "j"), None, False, jhp, "synthetic",
                       logger=JaxLogger(None, quiet=True))
    with pytest.raises(ValueError) as p_err:
        loop.train(str(tmp_path / "p"), None, False, port_hp(jhp),
                   "synthetic", logger=MetricLogger(None, quiet=True),
                   device="cpu")
    assert str(p_err.value) == str(j_err.value)


@pytest.mark.parametrize("over", [dict(mesh_shape=[2])])
def test_loop_refuses_what_is_not_ported(tmp_path, over):
    """A mesh of more than one device needs a process group of that many
    processes, one device each: without one the loop raises a ValueError
    naming both numbers before any data is read, and never trains the
    mesh alone."""
    jhp = jax_tiny_hp(**over)
    with pytest.raises(ValueError, match=r"mesh shape \(2,\) has 2 devices "
                       r"but the process group has 1 process"):
        loop.train(str(tmp_path), None, False, port_hp(jhp), "synthetic",
                   logger=MetricLogger(None, quiet=True), device="cpu")


@pytest.mark.parametrize("over", [
    dict(diversity_weight=1.0),
    dict(diversity_rescue_floor=0.5, validation_sample_diversity=3,
         diversity_weight=1.0),
    dict(adversarial_rollouts=True, style_reconstruction_weight=1.0,
         use_noise=False, noise_size=0),
    dict(adversarial_rollouts=True, diversity_weight=1.0,
         factor_rescue_floor=2.0, style_code_dims=2,
         validation_sample_diversity=3, factor_rescue_actuator="recon"),
    dict(adversarial_rollouts=True, quantized_inference=True),
])
def test_loop_identification_guards_raise_as_jax(tmp_path, over):
    """Identification settings that pass the loop's own guards and fail
    the steps' (``make_train_steps``, reached once the data and the state
    are built): JAX's ``train`` and the port's raise the same exception
    with the same message."""
    jhp = jax_tiny_hp(**over)
    with pytest.raises((ValueError, NotImplementedError)) as j_err:
        jax_loop.train(str(tmp_path / "j"), None, False, jhp, "synthetic",
                       logger=JaxLogger(None, quiet=True))
    with pytest.raises(j_err.type) as p_err:
        loop.train(str(tmp_path / "p"), None, False, port_hp(jhp),
                   "synthetic", logger=MetricLogger(None, quiet=True),
                   device="cpu")
    assert str(p_err.value) == str(j_err.value)


def test_metric_logger_writes_jax_keys(tmp_path):
    """The port's MetricLogger writes the JAX logger's JSONL file, keys and
    values for the same calls."""
    out = {}
    for side, cls in (("jax", JaxLogger), ("port", MetricLogger)):
        d = str(tmp_path / side)
        log = cls(d, run_name="run", quiet=True)
        log.log_values(3, mel_loss=np.float32(1.5), generator_loss=2.0,
                       discriminator_grad_norm=torch.tensor(0.25).item())
        log.log_validation(1.0, 0.5, 0.0, 4)
        log.log_values(4, sample_diversity=0.125)
        log.close()
        with open(os.path.join(d, "run.metrics.jsonl")) as f:
            out[side] = [{k: v for k, v in json.loads(l).items()
                          if k != "time"} for l in f]
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"step": 4, "Validation mel loss": 1.0,
                              "Validation gate loss": 0.5,
                              "Validation attention loss": 0.0}


@pytest.mark.parametrize("over", [
    dict(diversity_rescue_floor=0.5, diversity_rescue_gain=2.0,
         diversity_rescue_max=8.0),
    dict(diversity_rescue_ceiling=4.0, diversity_rescue_gain=3.0,
         diversity_rescue_max=4.5),
    dict(diversity_rescue_floor=0.5, diversity_rescue_ceiling=4.0),
    dict(factor_rescue_floor=2.0, factor_rescue_warmup=3,
         diversity_rescue_gain=2.0, diversity_rescue_max=6.0),
    {}])
def test_rescue_controllers_match_jax(over):
    """The two rescue controllers, pure host functions copied from the JAX
    loop, step for step over a sweep of sensor readings."""
    jhp = jax_tiny_hp(**over)
    hp = port_hp(jhp)
    readings = [0.1, 0.2, 0.9, 5.0, 7.5, 1.0, 0.3, 3.0, 9.0, 0.05]
    j = p = 1.0
    js = ps = [1.0, 1.0, 1.0]
    for it, r in enumerate(readings):
        j = jax_loop.update_rescue_scale(j, r, jhp)
        p = loop.update_rescue_scale(p, r, hp)
        assert p == j
        dims = [r, 3.0 - r / 4, 2.5]
        js = jax_loop.update_factor_scales(js, dims, jhp, it)
        ps = loop.update_factor_scales(ps, dims, hp, it)
        assert ps == js


def test_max_seconds_stops_as_jax(tmp_path, monkeypatch):
    """``max_seconds`` stops both loops after the first iteration that ends
    past it, with one validation and checkpoint there."""
    jhp = jax_tiny_hp(**dict(RUN, iterations=50, validation_audio=False))
    monkeypatch.setattr(jax_taco, "_dropout", lambda x, r, k: x)
    monkeypatch.setattr(jax_disc, "_dropout", lambda x, r, k: x)
    patch_port_state(monkeypatch)
    out = {}
    for side, fn, logger, kw in (
            ("jax", jax_loop.train, JaxLogger, {}),
            ("port", loop.train, MetricLogger, {"device": "cpu"})):
        d = str(tmp_path / side)
        _, it = fn(d, None, False, jhp if side == "jax" else port_hp(jhp),
                   "synthetic", logger=logger(None, quiet=True),
                   max_seconds=1e-9, **kw)
        out[side] = (it, sorted(CheckpointManager.parse_name(n)[0]
                                for n in os.listdir(d) if n.endswith(".ckpt")))
    assert out["port"] == out["jax"] == (1, [1])
