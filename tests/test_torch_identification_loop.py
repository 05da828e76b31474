"""Port parity of the training loop's identification machinery: the latent
separation probe, the collapse-rescue and factor-aware rescue controllers
wired to their sensors and actuators, and ``identification_warmup``,
against the JAX package's ``train()`` (gantron_tpu/train/loop.py); and the
style encoder carried through checkpoints, resume, warm start and
``Synthesizer.from_checkpoint``.

Both loops start from one JAX state with the gate pinned (no rollout
stops), dropout off. The port's G and D steps are wrapped to take the draws
that the JAX steps make from their state's key (replayed from the initial
key: a G step splits it in 7, a D step in 4), and the probe's style grids
are JAX's for the same iteration and dim. Validation losses are not
compared: the teacher-forced validation draws its noise on each side.
"""

import functools
import os
import shutil

import numpy as np
import pytest

import jax
import torch

import gantron_tpu.eval.sampling as jax_sampling
import gantron_tpu.models.discriminator as jax_disc
import gantron_tpu.models.tacotron2 as jax_taco
import gantron_tpu.train.loop as jax_loop
from gantron_tpu.train.state import create_train_state as jax_create_state
from gantron_tpu.utils.logging import MetricLogger as JaxLogger
from gantron_tpu_torch.eval import sampling
from gantron_tpu_torch.models.modules import disable_dropout
from gantron_tpu_torch.train import loop
from gantron_tpu_torch.train.checkpoint import (CheckpointManager,
                                                warm_start_filter)
from gantron_tpu_torch.train.state import create_train_state
from gantron_tpu_torch.tts import Synthesizer
from gantron_tpu_torch.utils.device import derive_seed
from gantron_tpu_torch.utils.jax_weights import train_state_from_jax
from gantron_tpu_torch.utils.loading import (load_checkpoint_tree,
                                             load_generator)
from gantron_tpu_torch.utils.logging import MetricLogger
from test_loop import tiny_hp as jax_tiny_hp
from test_torch_identification import (GATE_NEVER,  # noqa: F401
                                       one_torch_thread, pin_gate,
                                       rollout_draws, tf_style)
from test_torch_loop import LOSS_FLOOR, LOSS_RTOL, np_tree, port_hp, records

# The factorial study's rescue arm (scripts/gan_factorial_study.py
# "bit2x2_rescue_q": the recon actuator and the diagonal controller's
# ceiling; a probe of 8 rows cut to 4) with identification_warmup cut to 3
# and factor_rescue_warmup to 0, at test_loop's tiny widths: validations at
# 4 and 8. The ceiling and the floor are set among the separation ratios
# this tiny run measures (at 4: diagonal 0.684, dim 0 0.421, dim 1 0.372),
# so that both controllers act at 4: the diagonal ratio is above the
# ceiling (the rescue scale halves), and dim 1 falls below the floor (its
# weight doubles) while dim 0 holds.
RUN = dict(adversarial_rollouts=True, style_reconstruction_weight=10.0,
           diversity_weight=1.0, diversity_cap=0.9, style_code_dims=2,
           style_code_levels=2, diversity_subset_redraw=True,
           factor_rescue_floor=0.4, factor_rescue_warmup=0,
           factor_rescue_actuator="recon", diversity_rescue_ceiling=0.6,
           validation_sample_diversity=4, identification_warmup=3,
           iterations=8, iters_per_checkpoint=4, disc_warmp_up=7,
           attn_steps=4)
SKIP = ("time", "Generation duration", "Discriminator duration",
        "Data duration", "Validation duration", "Checkpoint duration")
PROBE = ("Sample diversity", "Identification separation",
         "Identification separation dim0", "Identification separation dim1")
SCALES = ("Identification rescue scale", "Factor rescue scale dim0",
          "Factor rescue scale dim1")


@functools.lru_cache(maxsize=None)
def jax_initial_state():
    """The state the JAX loop builds at RUN's shapes, gate pinned."""
    jhp = jax_tiny_hp(**RUN)
    train_loader, _ = jax_loop.prepare_dataloaders(jhp, "synthetic")
    state, *_ = jax_create_state(jhp, jax.random.PRNGKey(jhp.seed),
                                 tuple(next(iter(train_loader))))
    return np_tree(state.replace(
        g_params=pin_gate(np_tree(state.g_params), GATE_NEVER)))


def patch_jax_state(mp):
    """The JAX loop's initial state with the gate pinned
    (``jax_initial_state``)."""
    real = jax_loop.create_train_state

    def create(hp, rng, sample):
        state, *rest = real(hp, rng, sample)
        return (state.replace(g_params=pin_gate(np_tree(state.g_params),
                                                GATE_NEVER)), *rest)

    mp.setattr(jax_loop, "create_train_state", create)


def patch_port(mp, jhp):
    """The port loop starts from the JAX initial state, dropout off; its G
    and D steps take the JAX steps' draws, and its probe JAX's grids."""
    jax_state = jax_initial_state()
    gen = jax_taco.Tacotron2(jhp)
    rng = [jax_state.rng]
    real_make = loop.make_train_steps

    def create(hp, seed, sample, device):
        state, G, D, g_tx, d_tx = train_state_from_jax(jax_state, hp,
                                                       device="cpu")
        disable_dropout(G)
        disable_dropout(D)
        return state, G, D, g_tx, d_tx

    def make(hp, G, D, g_tx, d_tx, real=1.0):
        g_step, d_step, eval_step = real_make(hp, G, D, g_tx, d_tx, real)

        def g(state, batch, lr, attn, ident_scale=1.0, dim_weights=None):
            key = rng[0]
            rng[0] = jax.random.split(key, 7)[0]
            B = batch.text.shape[0]
            return g_step(state, batch, lr, attn, ident_scale, dim_weights,
                          style=tf_style(gen, key, B),
                          draws=rollout_draws(hp, key, B, gen))

        def d(state, *args):
            rng[0] = jax.random.split(rng[0], 4)[0]
            return d_step(state, *args)
        return g, d, eval_step

    iteration_of = {derive_seed(jhp.seed + 17, it): it for it in range(64)}
    real_grid = sampling.separation_grid_styles

    def grid(hp, L, S, generator, dim=None):
        it = iteration_of[generator.initial_seed()]
        # Draw the port's grid too, so that the decode's generator is
        # where it would be.
        real_grid(hp, L, S, generator, dim)
        k_style = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(jhp.seed + 17), it))[0]
        return torch.from_numpy(np.array(jax_sampling.separation_grid_styles(
            jhp, L, S, k_style, dim=dim)))

    mp.setattr(loop, "create_train_state", create)
    mp.setattr(loop, "make_train_steps", make)
    mp.setattr(sampling, "separation_grid_styles", grid)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ident_loops")
    jhp = jax_tiny_hp(**RUN)
    hp = port_hp(jhp)
    dirs = {"jax": str(root / "jax"), "port": str(root / "port")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_taco, "_dropout", lambda x, r, k: x)
        mp.setattr(jax_disc, "_dropout", lambda x, r, k: x)
        patch_jax_state(mp)
        jax_loop.train(dirs["jax"], None, False, jhp, "synthetic",
                       logger=JaxLogger(dirs["jax"], run_name="m",
                                        quiet=True))
        patch_port(mp, jhp)
        p_state, p_it = loop.train(
            dirs["port"], None, False, hp, "synthetic",
            logger=MetricLogger(dirs["port"], run_name="m", quiet=True),
            device="cpu")
    return dict(dirs=dirs, hp=hp, p_state=p_state, p_it=p_it,
                j=records(os.path.join(dirs["jax"], "m.metrics.jsonl")),
                p=records(os.path.join(dirs["port"], "m.metrics.jsonl")))


def _ident_part(rec, it):
    """Generator loss minus every term that is not an identification
    term: ident_scale x (the weighted identification terms)."""
    attn = 10.0 * rec["Attention loss"] if it < RUN["attn_steps"] else 0.0
    return (rec["Generator loss"] - rec["Taco loss"]
            - rec["Adversarial loss"] - rec["Rollout adversarial loss"]
            - attn)


def test_identification_loop_matches_jax(runs):
    """The same G/D sequence and per-iteration metrics (the rollout and
    identification terms among them) within the loop tests' LOSS_RTOL;
    the probe's separation ratios (diagonal and per dim) and spread within
    1e-3 and the controllers' scales equal at both validations; the
    identification terms off for the warm-up's 3 iterations and on after,
    scaled by the rescue scale from the validation at 4 on."""
    j, p = runs["j"], runs["p"]
    assert runs["p_it"] == 8 and sorted(p) == sorted(j)
    for step in sorted(j):
        jr = {k: v for k, v in j[step].items() if k not in SKIP}
        pr = {k: v for k, v in p[step].items() if k not in SKIP}
        assert sorted(pr) == sorted(jr), (step, sorted(pr), sorted(jr))
        for k, jv in jr.items():
            if k.startswith("Validation"):
                continue
            tol = (1e-3 * abs(jv) if k in PROBE
                   else 0.0 if k in SCALES
                   else LOSS_RTOL * max(abs(jv), LOSS_FLOOR))
            assert abs(pr[k] - jv) <= tol, (step, k, pr[k], jv)
    for step in (4, 8):
        assert all(k in p[step] for k in PROBE + SCALES), step
    # Both controllers acted at 4: the diagonal one attenuates, the
    # per-dim one holds dim 0 and escalates dim 1.
    assert [p[4][k] for k in SCALES] == [0.5, 1.0, 2.0]
    g_steps = [s for s in range(8) if "Generator loss" in p[s]]
    for s in g_steps:
        ident = _ident_part(p[s], s)
        recon_div = (10.0 * p[s]["Style reconstruction loss"]
                     - p[s]["Style diversity ratio"])
        scale = (0.0 if s < RUN["identification_warmup"]
                 else 1.0 if s < 4 else p[4][SCALES[0]])
        assert abs(ident - scale * recon_div) <= 1e-5 * max(
            abs(p[s]["Generator loss"]), 1.0), (s, ident, scale, recon_div)
        assert abs(_ident_part(j[s], s) - ident) <= 1e-4, s
    assert [s for s in g_steps if s >= RUN["identification_warmup"]]


def test_checkpoint_resume_and_serving_carry_the_style_encoder(runs,
                                                                tmp_path):
    """The latest checkpoint holds the style encoder and its Adam moments
    bit-equal to the live state; a resume restores them into a fresh
    state; ``warm_start_filter``, ``load_generator`` and
    ``Synthesizer.from_checkpoint`` take them."""
    hp, live = runs["hp"], runs["p_state"]
    path = CheckpointManager(runs["dirs"]["port"]).latest()
    assert CheckpointManager.parse_name(path)[0] == 8
    payload = load_checkpoint_tree(path)
    names = [n for n, _ in live.g_model.named_parameters()]
    se = [n for n in names if n.startswith("style_encoder.")]
    assert sorted(se) == sorted(
        f"style_encoder.{n}" for n in ("conv_0.weight", "conv_0.bias",
                                       "conv_1.weight", "conv_1.bias",
                                       "out_w", "out_b"))
    params = dict(live.g_model.named_parameters())
    for n in se:
        i = names.index(n)
        assert torch.equal(payload["g_state"][n], params[n].detach())
        assert torch.equal(payload["g_opt_state"]["mu"][n],
                           live.g_opt_state.mu[i])
        assert torch.equal(payload["g_opt_state"]["nu"][n],
                           live.g_opt_state.nu[i])

    batch = next(iter(loop.prepare_dataloaders(hp, "synthetic", "cpu")[0]))
    fresh, G, *_ = create_train_state(hp, 5, batch, device="cpu")
    CheckpointManager(str(tmp_path)).restore(path, fresh)
    assert fresh.step == 8
    for n in se:
        i = names.index(n)
        assert torch.equal(dict(G.named_parameters())[n], params[n])
        assert torch.equal(fresh.g_opt_state.mu[i], live.g_opt_state.mu[i])
    merged = warm_start_filter(G.state_dict(), payload["g_state"],
                               hp.ignore_layers)
    assert all(torch.equal(merged[n], payload["g_state"][n]) for n in se)
    for model in (load_generator(path, hp, device="cpu"),
                  Synthesizer.from_checkpoint(path, hp, device="cpu").model):
        got = dict(model.named_parameters())
        assert all(torch.equal(got[n], params[n]) for n in se)

    # Auto-resume to 10 iterations: two more steps from the restored state.
    out = str(tmp_path / "resume")
    shutil.copytree(runs["dirs"]["port"], out)
    hp2 = port_hp(jax_tiny_hp(**dict(RUN, iterations=10)))
    state, it = loop.train(out, None, False, hp2, "synthetic",
                           logger=MetricLogger(out, run_name="r",
                                               quiet=True),
                           device="cpu")
    assert it == 10 and state.step == 10
    resumed = records(os.path.join(out, "r.metrics.jsonl"))
    assert sorted(resumed) == [8, 9, 10]
    moved = dict(state.g_model.named_parameters())
    assert any(not torch.equal(moved[n], params[n]) for n in se)
