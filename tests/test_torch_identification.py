"""Port parity of the identification machinery's model and step: the InfoGAN
``StyleEncoder``, the differentiable rollout (``Tacotron2.rollout``), the
code draws and deltas, and one G step with the rollout and identification
terms, against the JAX package's (gantron_tpu/models/tacotron2.py,
gantron_tpu/train/step.py).

Dropout is off on both sides and every draw is injected: the port's draw
functions and G step take the uniforms and integers that the JAX functions
draw from their keys. The gate bias is pinned far from the threshold, so a
float32 difference cannot flip a rollout's length.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import gantron_tpu.models.tacotron2 as jax_taco
import gantron_tpu.train.step as jax_step
from gantron_tpu.train.state import create_train_state as jax_create_state
from gantron_tpu.train.step import make_train_steps as jax_make_steps
from gantron_tpu_torch.models.modules import disable_dropout
from gantron_tpu_torch.train import step as port_step
from gantron_tpu_torch.train.state import (B1, BN_FED_BIAS, compare_states,
                                           create_train_state)
from gantron_tpu_torch.train.step import (Batch, FlipDraws, RedrawDraws,
                                          make_train_steps, to_device)
from gantron_tpu_torch.utils.jax_weights import (tacotron2_from_jax,
                                                 train_state_from_jax)
from test_torch_train import (ATTN_W, G_LR, STEP_TOL,  # noqa: F401
                              jax_dropout_off, np_tree, port_hp, rel_close)
from test_train_step import synth_batch, tiny_hp
from torch_threads import one_torch_thread  # noqa: F401

# The study arms (scripts/gan_composed_study.py "full",
# scripts/gan_factorial_study.py "bit2x2_rescue_q" with the three code
# terms) and two more flag sets, at tiny widths.
ARM_A = dict(adversarial_rollouts=True, style_reconstruction_weight=10.0,
             diversity_weight=1.0, diversity_cap=0.9, style_code_dims=1,
             style_code_levels=2, gradient_penalty_lambda=10.0)
_BIT2X2 = dict(adversarial_rollouts=True, style_reconstruction_weight=10.0,
               diversity_weight=1.0, diversity_cap=0.9, style_code_dims=2,
               style_code_levels=2, diversity_subset_redraw=True,
               factor_rescue_floor=2.18)
ARM_B = dict(_BIT2X2, factor_rescue_actuator="recon",
             code_modularity_weight=1.0, code_additivity_weight=1.0,
             code_orthogonal_reward=True)
# The redraw actuator on a continuous code: weighted flip dims and
# continuous shifts (the additivity term's four decodes).
REDRAW_CONTINUOUS = dict(_BIT2X2, style_code_levels=0,
                         factor_rescue_actuator="redraw",
                         code_additivity_weight=1.0)
# bfloat16, the redraw actuator biasing the subset redraw itself.
REDRAW_BF16 = dict(_BIT2X2, factor_rescue_actuator="redraw", fp16_run=True)
GATE_NEVER = -8.0  # sigmoid(gate) stays far below gate_threshold 0.5
B = 4


def pin_gate(params, bias, zero_weights=False):
    """A copy of a JAX params tree with the decoder's gate bias at ``bias``
    (and its gate weights 0)."""
    params = jax.tree_util.tree_map(np.array, params)
    params["decoder"]["gate_b"][:] = bias
    if zero_weights:
        params["decoder"]["gate_w"][:] = 0.0
    return params


class IdentRun:
    """A JAX training setup with identification flags: the state (gate
    pinned), the jitted G step and the batch; ``port`` carries the state
    over."""

    def __init__(self, **over):
        self.jhp = tiny_hp(**over)
        self.hp = port_hp(self.jhp)
        self.batch = synth_batch(self.jhp, B=B)
        state, self.gen, self.disc, g_tx, d_tx = jax_create_state(
            self.jhp, jax.random.PRNGKey(0), tuple(self.batch))
        self.state = state.replace(
            g_params=pin_gate(np_tree(state.g_params), GATE_NEVER))
        g, _, _ = jax_make_steps(self.jhp, self.gen, self.disc, g_tx, d_tx)
        self.g_step = jax.jit(g)

    def port(self, state=None, hp=None):
        hp = hp or self.hp
        p_state, G, D, g_tx, d_tx = train_state_from_jax(
            np_tree(state or self.state), hp, device="cpu")
        disable_dropout(G)
        disable_dropout(D)
        return p_state, make_train_steps(hp, G, D, g_tx, d_tx)

    def port_batch(self):
        return to_device(Batch(*np_tree(tuple(self.batch))), "cpu")


def tf_style(gen, rng, batch_size, dtype=jnp.float32):
    """The style the JAX G step's teacher-forced pass draws from the state's
    key ``rng``."""
    k_noise = jax.random.split(rng, 7)[2]
    noise_rng = gen.apply({}, rngs={"noise": k_noise},
                          method=lambda m: m.make_rng("noise"))
    k_mem = jax.random.split(noise_rng)[1]
    return torch.from_numpy(np.array(jax.random.uniform(
        k_mem, (batch_size, 1, gen.noise_size), dtype=dtype), np.float32))


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(dtype) if dtype is not None else t


def _shift_draw(key, shape, levels):
    return (jax.random.uniform(key, shape) if levels == 0
            else jax.random.randint(key, shape, 1, levels))


def rollout_draws(hp, state_rng, batch_size, gen):
    """The rollout draws of the JAX G step from ``state_rng``
    (train/step.py g_step), as the port's ``draws`` argument; ``gen`` is
    the JAX generator module."""
    noise_size = gen.noise_size
    k_roll_noise = jax.random.split(state_rng, 7)[5]
    dims = int(hp.style_code_dims) or noise_size
    levels = int(hp.style_code_levels)
    if not (hp.style_reconstruction_weight > 0 or hp.diversity_weight > 0):
        # No term reads the style: JAX's infer draws it from its "noise"
        # stream (encode_memory).
        noise_rng = gen.apply({}, rngs={"noise": k_roll_noise},
                              method=lambda m: m.make_rng("noise"))
        return dict(style=_t(jax.random.uniform(
            noise_rng, (batch_size, 1, noise_size))))
    k_style = jax.random.fold_in(k_roll_noise, 1)
    style = jax.random.uniform(k_style, (batch_size, 1, noise_size))
    if levels:
        k = jax.random.randint(jax.random.fold_in(k_style, 7),
                               (batch_size, 1, dims), 0, levels)
        style = style.at[:, :, :dims].set(
            (k.astype(jnp.float32) + 0.5) / levels)
    code_shape = (batch_size, 1, dims)
    key = jax.random.fold_in(k_roll_noise, 2)
    if levels == 0:
        redraw = RedrawDraws(_t(jax.random.uniform(key, code_shape)))
    elif hp.diversity_subset_redraw and dims > 1:
        k_off, k_mask, k_force = jax.random.split(key, 3)
        redraw = RedrawDraws(
            _t(jax.random.randint(k_off, code_shape, 1, levels), torch.long),
            _t(jax.random.uniform(k_mask, code_shape)),
            _t(jax.random.randint(k_force, code_shape[:-1], 0, dims),
               torch.long),
            _t(jax.random.gumbel(k_force, code_shape)))
    else:
        redraw = RedrawDraws(_t(jax.random.randint(key, code_shape, 1,
                                                   levels), torch.long))
    draws = dict(style=_t(style), redraw=redraw)
    if dims > 1:
        k_i = jax.random.fold_in(k_roll_noise, 3)
        long = torch.long if levels else None
        draws["flip"] = FlipDraws(
            i=_t(jax.random.randint(k_i, (batch_size,), 0, dims), torch.long),
            gumbel=_t(jax.random.gumbel(k_i, (batch_size, dims))),
            j=_t(jax.random.randint(jax.random.fold_in(k_roll_noise, 4),
                                    (batch_size,), 1, dims), torch.long),
            shift_i=_t(_shift_draw(jax.random.fold_in(k_roll_noise, 5),
                                   code_shape, levels), long),
            shift_j=_t(_shift_draw(jax.random.fold_in(k_roll_noise, 6),
                                   code_shape, levels), long))
    return draws


@pytest.fixture(scope="module")
def arm_a(jax_dropout_off):
    return IdentRun(**ARM_A)


@pytest.fixture(scope="module")
def arm_b(jax_dropout_off):
    return IdentRun(**ARM_B)


# -- the style encoder --------------------------------------------------------
@pytest.mark.parametrize("T", [24, 25])
def test_style_encoder_matches_jax(arm_a, T):
    """``predict_style`` over an even and an odd number of frames (Flax's
    "SAME" padding is 1/2 frames for even T, 2/2 for odd), ragged lengths
    (the pooled mask is (length + 3) // 4 frames), carried over by the
    weight bridge."""
    rng = np.random.RandomState(T)
    mel = rng.randn(3, arm_a.hp.n_mel_channels, T).astype(np.float32)
    lengths = np.array([T, T - 7, 5], np.int32)
    params = arm_a.state.g_params
    j = jax_taco.StyleEncoder(arm_a.jhp, 1).apply(
        {"params": params["style_encoder"]}, jnp.asarray(mel),
        jnp.asarray(lengths))
    port = tacotron2_from_jax(params, np_tree(arm_a.state.g_batch_stats),
                              arm_a.hp, device="cpu")
    p = port.predict_style(torch.from_numpy(mel),
                           torch.from_numpy(lengths).long())
    assert tuple(p.shape) == (3, 1)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), atol=1e-6)


# -- the differentiable rollout -----------------------------------------------
@pytest.mark.parametrize("stop", [False, True])
def test_rollout_and_its_gradient_match_jax(arm_a, stop):
    """``Tacotron2.rollout`` on a padded batch against JAX's ``infer``
    (dropout off, style injected), with the gate pinned so that no sample
    stops, or every sample stops at the first step: mel, gate and
    alignments within 1e-5, lengths exact; the gradient of a scalar of the
    rollout with respect to every weight (the in-loop LSTM and attention
    weights included) against ``jax.grad`` within 1e-4 of each tensor's
    largest entry; the rollout equals the no-grad ``infer``."""
    jhp, hp = arm_a.jhp, arm_a.hp
    params = pin_gate(arm_a.state.g_params, 8.0 if stop else GATE_NEVER,
                      zero_weights=stop)
    stats = np_tree(arm_a.state.g_batch_stats)
    rng = np.random.RandomState(11)
    S, K = 10, 1
    text = np.array(arm_a.batch.text)[:3]
    text_lengths = np.array(arm_a.batch.text_lengths)[:3]
    style = rng.rand(3, 1, hp.noise_size).astype(np.float32)
    w_mel = rng.randn(3, hp.n_mel_channels, S * K).astype(np.float32)
    w_gate = rng.randn(3, S * K).astype(np.float32)
    model = jax_taco.Tacotron2(jhp)

    def run(p):
        return model.apply({"params": p, "batch_stats": stats},
                           jnp.asarray(text), jnp.asarray(style), None, None,
                           S, method=model.infer,
                           text_lengths=jnp.asarray(text_lengths),
                           rngs={"dropout": jax.random.PRNGKey(0),
                                 "noise": jax.random.PRNGKey(1)})

    def scalar(p):
        out = run(p)
        return jnp.sum(out[1] * w_mel) + jnp.sum(out[2] * w_gate)

    j_out = run(params)
    j_grads = jax.jit(jax.grad(scalar))(params)
    port = disable_dropout(tacotron2_from_jax(params, stats, hp, "cpu"))
    args = (torch.from_numpy(text).long(), torch.from_numpy(style), None,
            None, S)
    p_out = port.rollout(*args, text_lengths=torch.from_numpy(
        text_lengths).long())
    for name, a, b in zip(("mel", "mel_postnet", "gate", "alignments"),
                          p_out[:4], j_out[:4]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, err_msg=name)
    expected = np.full(3, 1 if stop else S)
    np.testing.assert_array_equal(np.asarray(j_out[4]), expected)
    np.testing.assert_array_equal(p_out[4].numpy(), expected)
    for a, b in zip(port.infer(*args, text_lengths=torch.from_numpy(
            text_lengths).long()), p_out):
        assert torch.equal(a, b.detach())

    loss = (torch.sum(p_out[1] * torch.from_numpy(w_mel))
            + torch.sum(p_out[2] * torch.from_numpy(w_gate)))
    names = [n for n, _ in port.named_parameters()]
    p_grads = torch.autograd.grad(loss, list(port.parameters()),
                                  allow_unused=True)
    # JAX's gradient tree in the port's layout: the bridge reads it as
    # parameters.
    ref = tacotron2_from_jax(np_tree(j_grads), stats, hp, "cpu")
    checked = 0
    for name, g, r in zip(names, p_grads, ref.parameters()):
        r = r.detach().numpy()
        if name.startswith("style_encoder"):
            assert g is None and not r.any(), name
            continue
        top = np.abs(r).max()
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4 * top,
                                   err_msg=name)
        checked += name.startswith("decoder.")
    assert checked == len([n for n in names if n.startswith("decoder.")])


# -- draws and deltas ---------------------------------------------------------
def _code(rng, shape, levels):
    if levels == 0:
        return rng.rand(*shape).astype(np.float32)
    return ((rng.randint(0, levels, shape) + 0.5) / levels).astype(np.float32)


@pytest.mark.parametrize("levels,subset,weights", [
    (2, False, None), (3, False, None), (0, False, None),
    (3, True, None), (3, True, [1.0, 4.0, 0.5]), (2, True, [2.0, 2.0, 2.0]),
])
def test_redraw_code_matches_jax(levels, subset, weights):
    """``redraw_code`` given JAX's draws: all dims, a subset, a subset with
    non-uniform weights (weighted mask and forced dim) and with uniform
    weights (the unweighted draws exactly)."""
    rng = np.random.RandomState(levels + 10 * subset)
    shape = (6, 1, 3)
    code = _code(rng, shape, levels)
    key = jax.random.PRNGKey(7)
    w = None if weights is None else jnp.asarray(weights)
    j = jax_step.redraw_code(key, jnp.asarray(code), levels, subset=subset,
                             dim_weights=w)
    if levels == 0:
        draws = RedrawDraws(_t(jax.random.uniform(key, shape)))
    elif subset:
        k_off, k_mask, k_force = jax.random.split(key, 3)
        draws = RedrawDraws(
            _t(jax.random.randint(k_off, shape, 1, levels), torch.long),
            _t(jax.random.uniform(k_mask, shape)),
            _t(jax.random.randint(k_force, shape[:-1], 0, 3), torch.long),
            _t(jax.random.gumbel(k_force, shape)))
    else:
        draws = RedrawDraws(_t(jax.random.randint(key, shape, 1, levels),
                               torch.long))
    p = port_step.redraw_code(
        None, torch.from_numpy(code), levels, subset=subset,
        dim_weights=None if weights is None else torch.tensor(weights),
        draws=draws)
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    if levels:
        # Every sample's code moves in at least one dim.
        assert not (p.numpy() == code).all(axis=-1).any()


@pytest.mark.parametrize("levels", [3, 0])
def test_shift_code_masked_and_draw_code_match_jax(levels):
    rng = np.random.RandomState(levels)
    shape = (5, 1, 3)
    code = _code(rng, shape, levels)
    mask = rng.rand(*shape) < 0.5
    key = jax.random.PRNGKey(3)
    j = jax_step.shift_code_masked(key, jnp.asarray(code), levels,
                                   jnp.asarray(mask))
    draw = _shift_draw(key, shape, levels)
    p = port_step.shift_code_masked(
        None, torch.from_numpy(code), levels, torch.from_numpy(mask),
        _t(draw, torch.long if levels else None))
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    # _draw_code: the JAX closure's two forms.
    if levels:
        k = jax.random.randint(key, shape, 0, levels)
        j_code = (k.astype(jnp.float32) + 0.5) / levels
        p_code = port_step.draw_code(None, shape, levels,
                                     draw=_t(k, torch.long))
    else:
        j_code = jax.random.uniform(key, shape)
        p_code = port_step.draw_code(None, shape, 0, draw=_t(j_code))
    np.testing.assert_array_equal(p_code.numpy(), np.asarray(j_code))
    gen = torch.Generator().manual_seed(0)
    drawn = port_step.draw_code(gen, (400,), levels).numpy()
    if levels:
        assert set(np.round(drawn * levels - 0.5).astype(int)) == {0, 1, 2}
    else:
        assert 0 <= drawn.min() and drawn.max() < 1


def test_deltas_match_jax():
    rng = np.random.RandomState(5)
    B, M, T = 4, 6, 9
    mels = [rng.randn(B, M, T).astype(np.float32) for _ in range(4)]
    mels[2][1] = mels[0][1]  # a dead dim: |delta| = 0 for sample 1
    lens = [rng.randint(1, T + 1, B).astype(np.int32) for _ in range(4)]
    j_args = [jnp.asarray(m) for m in mels] + [jnp.asarray(n) for n in lens]
    p_args = ([torch.from_numpy(m) for m in mels]
              + [torch.from_numpy(n).long() for n in lens])
    three = [0, 1, 2, 4, 5, 6]
    np.testing.assert_allclose(
        port_step.delta_cos(*[p_args[i] for i in three]).numpy(),
        np.asarray(jax_step.delta_cos(*[j_args[i] for i in three])),
        rtol=1e-6, atol=1e-7)
    rel_close(port_step.delta_orthogonality(*[p_args[i] for i in three]),
              jax_step.delta_orthogonality(*[j_args[i] for i in three]),
              1e-6, "orthogonality")
    rel_close(port_step.delta_additivity(*p_args),
              jax_step.delta_additivity(*j_args), 1e-6, "additivity")


# -- one G step ---------------------------------------------------------------
def g_step_both(run, p_state, g_step, dim_weights=None, ident_scale=1.0,
                dtype=jnp.float32):
    """One G step on both sides from ``run.state`` with JAX's draws
    injected; returns (JAX state, JAX metrics, JAX fake pair, port state,
    port metrics, port fake pair)."""
    state = run.state
    extra = ([] if dim_weights is None
             else [jnp.asarray(dim_weights, jnp.float32)])
    j_state, j_m, j_fake = run.g_step(state, run.batch, jnp.float32(G_LR),
                                      jnp.float32(ATTN_W),
                                      jnp.float32(ident_scale), *extra)
    draws = rollout_draws(run.hp, state.rng, B, run.gen)
    p_state, p_m, p_fake = g_step(
        p_state, run.port_batch(), G_LR, ATTN_W, ident_scale,
        None if dim_weights is None else torch.tensor(dim_weights),
        style=tf_style(run.gen, state.rng, B, dtype), draws=draws)
    return j_state, j_m, j_fake, p_state, p_m, p_fake


# The Adam first moments (the gradients) of a G step with rollouts,
# relative to each tensor's largest: D's score of the rollout reaches the
# encoder and postnet through S = 24 recurrent steps, and float32 rounding
# there differs with the order of the sums. The JAX package's own step,
# jitted and op by op (jax.disable_jit), disagrees with itself by up to
# 1.7e-5 of the largest (the encoder's convs, the embedding); the port lies
# within 4.6e-5 of the jitted step. The rollout's gradient alone agrees to
# 2.4e-5 (test_rollout_and_its_gradient_match_jax holds it at 1e-4).
ROLLOUT_MOMENT_TOL = 1e-4


def assert_ident_states_match(p_state, j_state, hp, what):
    """``assert_states_match`` with the rollout's moment tolerance, and the
    conv biases before BatchNorm held as every other parameter: the
    rollout's encoder and postnet run on running statistics, which gives
    them a gradient."""
    ref, *_ = train_state_from_jax(np_tree(j_state), hp, device="cpu")
    compare_states(p_state, ref, moment_tol=ROLLOUT_MOMENT_TOL,
                   param_rtol=STEP_TOL["rtol"], param_atol=STEP_TOL["atol"],
                   floor=1e-4, noise_tol=None, stats_tol=1e-6, what=what)


def check_g_step(run, dim_weights=None):
    p_state, (g_step, _, _) = run.port()
    j_state, j_m, j_fake, p_state, p_m, p_fake = g_step_both(
        run, p_state, g_step, dim_weights)
    assert set(p_m) == set(j_m), (sorted(p_m), sorted(j_m))
    for k in j_m:
        rel_close(p_m[k], j_m[k], 1e-5, k)
    np.testing.assert_array_equal(p_fake[1].numpy(), np.asarray(j_fake[1]))
    np.testing.assert_allclose(p_fake[0].numpy(), np.asarray(j_fake[0]),
                               atol=1e-4)
    assert_ident_states_match(p_state, j_state, run.hp, "G step")
    return j_m


def test_g_step_arm_a_matches_jax(arm_a):
    """The composed study's "full" arm: rollouts scored by D (the rollout
    pair goes to the fake buffer), InfoGAN reconstruction of a 1-dim
    2-level code, the saturating diversity pair, WGAN-GP's D."""
    j_m = check_g_step(arm_a)
    assert {"rollout_adversarial_loss", "style_reconstruction_loss",
            "style_diversity_ratio"} <= set(j_m)


def test_g_step_arm_b_recon_actuator_matches_jax(arm_b):
    """The factorial study's rescue arm with the three code terms: the
    per-dim flip decodes (modularity, additivity, the orthogonal reward)
    and the recon actuator weighting the per-dim reconstruction errors by
    non-uniform weights."""
    j_m = check_g_step(arm_b, dim_weights=[1.0, 4.0])
    assert {"code_modularity_penalty", "code_additivity_penalty",
            "code_orthogonal_sin"} <= set(j_m)


def test_g_step_redraw_actuator_continuous_code_matches_jax(
        jax_dropout_off):
    """The redraw actuator on a 2-dim continuous code: the flip dims drawn
    by non-uniform weights, continuous shifts, the joint flip."""
    check_g_step(IdentRun(**REDRAW_CONTINUOUS), dim_weights=[1.0, 3.0])


def test_g_step_bf16_matches_jax(jax_dropout_off):
    """fp16_run: the rollouts and the style encoder on bfloat16 copies of
    the float32 masters, the redraw actuator biasing the subset redraw;
    metrics within 2e-2 relative (the adversarial losses within 2e-2 of
    1), lengths exact, every parameter of the generator moved, the masters
    still float32."""
    run = IdentRun(**REDRAW_BF16)
    p_state, (g_step, _, _) = run.port()
    before = [p.detach().clone() for p in p_state.g_model.parameters()]
    j_state, j_m, j_fake, p_state, p_m, p_fake = g_step_both(
        run, p_state, g_step, [3.0, 1.0], dtype=jnp.bfloat16)
    assert set(p_m) == set(j_m)
    for k in j_m:
        if k.endswith("adversarial_loss"):
            assert abs(float(p_m[k]) - float(j_m[k])) <= 2e-2, k
        else:
            rel_close(p_m[k], j_m[k], 2e-2, k)
    np.testing.assert_array_equal(p_fake[1].numpy(), np.asarray(j_fake[1]))
    names = [n for n, _ in p_state.g_model.named_parameters()]
    for name, a, b in zip(names, p_state.g_model.parameters(), before):
        assert a.dtype == torch.float32
        if not BN_FED_BIAS.match(name):
            assert not torch.equal(a.detach(), b), name
    assert any(n.startswith("style_encoder") for n in names)


def test_ident_scale_zero_is_the_step_without_the_terms(arm_a):
    """``ident_scale=0`` (identification warm-up) gives the rollout-only
    step's losses and updates; the style encoder gets no gradient."""
    p_state, (g_step, _, _) = arm_a.port()
    hp_roll = port_hp(tiny_hp(adversarial_rollouts=True,
                              gradient_penalty_lambda=10.0))
    r_state, (r_step, _, _) = arm_a.port(hp=hp_roll)
    draws = rollout_draws(arm_a.hp, arm_a.state.rng, B, arm_a.gen)
    style = tf_style(arm_a.gen, arm_a.state.rng, B)
    se_before = [p.detach().clone()
                 for p in p_state.g_model.style_encoder.parameters()]
    p_state, p_m, p_fake = g_step(p_state, arm_a.port_batch(), G_LR, ATTN_W,
                                  0.0, style=style, draws=draws)
    r_state, r_m, r_fake = r_step(r_state, arm_a.port_batch(), G_LR, ATTN_W,
                                  style=style, draws=draws)
    # The forward passes are the same computations: their losses are
    # equal; autograd may sum the same gradient contributions in another
    # order, so the updates agree to float32 rounding.
    for k in r_m:
        if k != "grad_norm":
            assert torch.equal(p_m[k], r_m[k]), k
    rel_close(p_m["grad_norm"], r_m["grad_norm"], 1e-6, "grad_norm")
    assert torch.equal(p_fake[0], r_fake[0])
    shared = dict(r_state.g_model.named_parameters())
    for name, p in p_state.g_model.named_parameters():
        if name.startswith("style_encoder"):
            continue
        np.testing.assert_allclose(p.detach().numpy(),
                                   shared[name].detach().numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    # Its gradient is 0: its first moment holds weight decay alone.
    names = [n for n, _ in p_state.g_model.named_parameters()]
    for name, b in zip([n for n in names if n.startswith("style_encoder")],
                       se_before):
        mu = p_state.g_opt_state.mu[names.index(name)]
        torch.testing.assert_close(
            mu, (1 - B1) * arm_a.hp.weight_decay * b, rtol=1e-6,
            atol=0)


def test_diversity_pair_shares_the_dropout_masks():
    """With the prenet's dropout on, the diversity pair's second decode
    redraws the first decode's masks: re-decoding the same code gives the
    same mel bit for bit, and a changed code a different one."""
    hp = port_hp(tiny_hp(**ARM_A))
    batch = to_device(Batch(*np_tree(tuple(synth_batch(tiny_hp(), B=2)))),
                      "cpu")
    state, G, D, g_tx, d_tx = create_train_state(hp, 0, batch, device="cpu")
    captured = []
    real_rollout = G.rollout

    def rollout(*args, **kwargs):
        out = real_rollout(*args, **kwargs)
        captured.append(out[1].detach().clone())
        return out

    G.rollout = rollout
    g_step, _, _ = make_train_steps(hp, G, D, g_tx, d_tx)
    draws = dict(style=torch.full((2, 1, hp.noise_size), 0.25),
                 redraw=RedrawDraws(torch.ones(2, 1, 1, dtype=torch.long)))
    g_step(state, batch, G_LR, ATTN_W, draws=draws)
    assert len(captured) == 2 and not torch.equal(captured[0], captured[1])
    # The same code: the redraw's offset of 0 mod 2 keeps it.
    captured.clear()
    draws["redraw"] = RedrawDraws(torch.full((2, 1, 1), 2, dtype=torch.long))
    g_step(state, batch, G_LR, ATTN_W, draws=draws)
    assert torch.equal(captured[0], captured[1])
