"""Port parity of the training slice: gantron_tpu_torch's teacher-forced
Tacotron2, losses, discriminators, optimizer and G/D steps against the JAX
package's, from the same weights and optimizer state
(utils/jax_weights.py).

Inputs are made with numpy from a seed and given to both sides. Dropout is
off on both (the JAX side by monkeypatching ``_dropout`` in its tacotron2 and
discriminator modules, the port by ``disable_dropout``), and the noise is
injected: the port's steps take the style that the JAX step draws.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import gantron_tpu.losses as jax_losses
import gantron_tpu.models.discriminator as jax_disc
import gantron_tpu.models.tacotron2 as jax_taco
from gantron_tpu.train.state import create_train_state as jax_create_state
from gantron_tpu.train.step import make_train_steps as jax_make_steps
from gantron_tpu_torch import losses
from gantron_tpu_torch.config import HParams
from gantron_tpu_torch.models.discriminator import make_discriminator
from gantron_tpu_torch.models.modules import BatchNorm, disable_dropout
from gantron_tpu_torch.train.state import (compare_states,
                                           create_train_state)
from gantron_tpu_torch.train.step import (Batch, make_train_steps,
                                          pad_mel_to_window, to_device)
from gantron_tpu_torch.utils.jax_weights import (discriminator_from_jax,
                                                 tacotron2_from_jax,
                                                 train_state_from_jax)
from test_torch_tacotron2 import (jax_variables, no_jax_dropout,  # noqa: F401
                                  tiny_hparams, variables_for)
from test_train_step import synth_batch, tiny_hp
from torch_threads import one_torch_thread  # noqa: F401

G_LR, D_LR, ATTN_W = 1e-3, 7e-4, 10.0
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
G_METRICS = ("mel_loss", "gate_loss", "attention_loss", "adversarial_loss",
             "taco_loss", "generator_loss", "grad_norm")
D_METRICS = ("discriminator_loss", "real_loss", "fake_loss",
             "gradient_penalty", "discriminator_grad_norm")


def port_hp(jhp):
    hp = HParams()
    hp.add_params(jhp.as_dict())
    return hp


def np_tree(tree):
    """Writable numpy copies of a JAX tree's leaves."""
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def rel_close(a, b, rtol, what):
    """|a - b| <= rtol |b|; ``a`` the port's scalar, ``b`` JAX's."""
    a = float(a.detach()) if torch.is_tensor(a) else float(a)
    b = float(b)
    assert abs(a - b) <= rtol * max(abs(b), 1e-6), (what, a, b)


@pytest.fixture(scope="module")
def jax_dropout_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_taco, "_dropout", lambda x, r, k: x)
        mp.setattr(jax_disc, "_dropout", lambda x, r, k: x)
        yield


class JaxRun:
    """One JAX training setup at test_train_step's tiny shapes: the state,
    the models and jitted steps, and the batch (numpy)."""

    def __init__(self, **over):
        self.jhp = tiny_hp(**over)
        self.hp = port_hp(self.jhp)
        self.batch = synth_batch(self.jhp)
        self.state, self.gen, self.disc, g_tx, d_tx = jax_create_state(
            self.jhp, jax.random.PRNGKey(0), tuple(self.batch))
        g, d, _ = jax_make_steps(self.jhp, self.gen, self.disc, g_tx, d_tx)
        self.g_step, self.d_step = jax.jit(g), jax.jit(d)

    def style(self, state, dtype=jnp.float32):
        """The style the JAX G step draws from ``state``'s key (its
        memory-side uniform draw), as float32 numpy."""
        k_noise = jax.random.split(state.rng, 7)[2]
        noise_rng = self.gen.apply({"params": state.g_params},
                                   rngs={"noise": k_noise},
                                   method=lambda m: m.make_rng("noise"))
        k_mem = jax.random.split(noise_rng)[1]
        B = self.batch.text.shape[0]
        return np.array(jax.random.uniform(
            k_mem, (B, 1, self.gen.noise_size), dtype=dtype), np.float32)

    def port(self, state):
        """The port's state, models and steps from a JAX state, dropout
        off."""
        p_state, G, D, g_tx, d_tx = train_state_from_jax(
            np_tree(state), self.hp, device="cpu")
        disable_dropout(G)
        disable_dropout(D)
        return p_state, make_train_steps(self.hp, G, D, g_tx, d_tx)

    def port_batch(self):
        return to_device(Batch(*np_tree(tuple(self.batch))), "cpu")


@pytest.fixture(scope="module")
def run(jax_dropout_off):
    return JaxRun()


@pytest.fixture(scope="module")
def run_no_deferred_dw(jax_dropout_off):
    """The same setup with the JAX step's deferred-dW backward off."""
    return JaxRun(deferred_dw=False)


@pytest.fixture(scope="module")
def run_gp(jax_dropout_off):
    return JaxRun(gradient_penalty_lambda=10.0)


def assert_states_match(p_state, j_state, hp, what):
    """The port's state after a step against the JAX state after the same
    step (``compare_states``): first moments within 1e-5 of themselves plus
    1e-5 of the tensor's largest, parameters within rtol 1e-5 / atol 1e-6
    wherever Adam's step is conditioned (the root of the second moment at
    least 1e-4 of the tensor's largest), BatchNorm running statistics within
    1e-6, and the conv biases before a training-mode BatchNorm holding noise
    under 1e-6 of the largest first moment."""
    ref, *_ = train_state_from_jax(np_tree(j_state), hp, device="cpu")
    compare_states(p_state, ref, moment_tol=1e-5,
                   param_rtol=STEP_TOL["rtol"], param_atol=STEP_TOL["atol"],
                   floor=1e-4, noise_tol=1e-6, stats_tol=1e-6, what=what)


def g_and_d_step(run, state, p_state, steps, metric_tol=1e-5):
    """One G step then one D step on both sides from the same state;
    returns the JAX state after both."""
    g_step, d_step, _ = steps
    batch = run.port_batch()
    style = torch.from_numpy(run.style(state))
    j_state, j_m, (j_mel, j_len) = run.g_step(
        state, run.batch, jnp.float32(G_LR), jnp.float32(ATTN_W))
    p_state, p_m, (p_mel, p_len) = g_step(p_state, batch, G_LR, ATTN_W,
                                          style=style)
    for k in G_METRICS:
        rel_close(p_m[k], j_m[k], metric_tol, k)
    np.testing.assert_allclose(p_mel.numpy(), np.asarray(j_mel), atol=1e-4)
    j_state, j_dm = run.d_step(j_state, run.batch.mels,
                               run.batch.output_lengths, j_mel, j_len,
                               jnp.float32(D_LR))
    p_state, p_dm = d_step(p_state, batch.mels, batch.output_lengths,
                           p_mel, p_len, D_LR)
    for k in D_METRICS:
        if k == "discriminator_loss":
            d_loss_close(p_dm, j_dm, metric_tol)
        else:
            rel_close(p_dm[k], j_dm[k], metric_tol, k)
    assert p_state.step == int(j_state.step)
    return j_state, p_state


def d_loss_close(p_dm, j_dm, tol):
    """The D loss (real_loss + fake_loss) / 2 within ``tol`` of the scale of
    its terms, (|real_loss| + |fake_loss|) / 2, JAX's; each term is held
    relative to itself by the caller. The two means of window scores almost
    cancel: in the first step from ``run``'s state they were -8.18e-3 and
    6.52e-3 against a loss of -8.32e-4, so a relative check on the loss
    multiplies float32 rounding in the terms by 8.8 (the port and JAX were
    1.0e-8 apart, 1.2e-5 relative, on an AMD EPYC host)."""
    scale = (abs(float(j_dm["real_loss"])) + abs(float(j_dm["fake_loss"])))
    a, b = float(p_dm["discriminator_loss"]), float(j_dm["discriminator_loss"])
    assert abs(a - b) <= tol * scale / 2, ("discriminator_loss", a, b, scale)


# -- models -------------------------------------------------------------------
@pytest.mark.parametrize("K", [1, 2])
def test_teacher_forced_forward_matches_jax(jax_variables, no_jax_dropout,
                                            K):
    """Train-mode forward (batch-statistics BatchNorm), dropout off: outputs
    and the updated BatchNorm running statistics."""
    jhp, hp = tiny_hparams(n_frames_per_step=K)
    variables = variables_for(jax_variables, K)
    rng = np.random.RandomState(4)
    B, T_in, T_out = 3, 9, 12
    text_lengths = np.array([9, 5, 7], np.int32)
    output_lengths = np.array([12, 7, 10], np.int32)
    text = np.zeros((B, T_in), np.int32)
    mels = (rng.randn(B, hp.n_mel_channels, T_out) * 0.5).astype(np.float32)
    for b in range(B):
        text[b, :text_lengths[b]] = rng.randint(1, hp.n_symbols,
                                                text_lengths[b])
        mels[b, :, output_lengths[b]:] = 0
    style = rng.rand(B, 1, hp.noise_size).astype(np.float32)
    model = jax_taco.Tacotron2(jhp)
    j_out, mutated = model.apply(
        variables, jnp.asarray(text), jnp.asarray(text_lengths),
        jnp.asarray(mels), jnp.zeros((B,), jnp.int32), jnp.zeros((B, 5)),
        jnp.asarray(output_lengths), train=True, style=jnp.asarray(style),
        rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
    port = disable_dropout(tacotron2_from_jax(
        variables["params"], variables["batch_stats"], hp, device="cpu"))
    p_out = port(torch.from_numpy(text).long(),
                 torch.from_numpy(text_lengths).long(),
                 torch.from_numpy(mels), torch.zeros(B, dtype=torch.long),
                 torch.zeros(B, 5), torch.from_numpy(output_lengths).long(),
                 train=True, style=torch.from_numpy(style))
    for name, a, b in zip(("mel", "mel_postnet", "gate", "alignments"),
                          p_out, j_out):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-4, err_msg=name)
    ref = tacotron2_from_jax(variables["params"],
                             np_tree(mutated["batch_stats"]), hp, "cpu")
    for (name, a), b in zip(port.named_buffers(), ref.buffers()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_batchnorm_train_form_is_flax_biased():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 3, 5).astype(np.float32) * 2 + 1)
    bn = BatchNorm(3)
    y = bn(x, train=True)
    mean = x.mean(dim=(0, 2))
    var = x.var(dim=(0, 2), unbiased=False)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * var.numpy(), rtol=1e-6)
    expected = (x - mean[:, None]) / torch.sqrt(var[:, None] + 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), expected.numpy(),
                               atol=1e-5)
    y_bf16 = bn(x.bfloat16(), train=True)
    assert y_bf16.dtype == torch.bfloat16
    assert bn.running_mean.dtype == torch.float32


# -- losses -------------------------------------------------------------------
@pytest.mark.parametrize("K", [1, 2])
def test_losses_match_jax(K):
    rng = np.random.RandomState(K)
    B, M, T, T_in = 3, 8, 12, 7
    mel_t = rng.randn(B, M, T).astype(np.float32)
    gate_t = (rng.rand(B, T) > 0.7).astype(np.float32)
    outs = [rng.randn(B, M, T).astype(np.float32),
            rng.randn(B, M, T).astype(np.float32),
            (rng.randn(B, T) * 3).astype(np.float32),
            rng.dirichlet(np.ones(T_in), (B, T // K)).astype(np.float32)]
    # 1 - att = 0 where the target is not 1: that element's BCE is
    # clamped at 100.
    outs[3][0, 0, :] = [0.0] * (T_in - 1) + [1.0]
    in_lens = np.array([7, 4, 6], np.int32)
    out_lens = np.array([12, 5, 9], np.int32)
    j = jax_losses.tacotron2_loss([jnp.asarray(o) for o in outs],
                                  (jnp.asarray(mel_t), jnp.asarray(gate_t)),
                                  jnp.asarray(in_lens), jnp.asarray(out_lens))
    p = losses.tacotron2_loss([torch.from_numpy(o) for o in outs],
                              (torch.from_numpy(mel_t),
                               torch.from_numpy(gate_t)),
                              torch.from_numpy(in_lens).long(),
                              torch.from_numpy(out_lens).long())
    for name, a, b in zip(("mel", "gate", "attention"), p, j):
        rel_close(a, b, 1e-5, name)
    rel_close(losses.mse(torch.from_numpy(outs[0]), torch.from_numpy(mel_t)),
              jax_losses.mse(jnp.asarray(outs[0]), jnp.asarray(mel_t)), 1e-5,
              "mse")
    rel_close(losses.bce_with_logits(torch.from_numpy(outs[2]),
                                     torch.from_numpy(gate_t)),
              jax_losses.bce_with_logits(jnp.asarray(outs[2]),
                                         jnp.asarray(gate_t)), 1e-5, "bce")


# -- discriminators -----------------------------------------------------------
@pytest.mark.parametrize("kind", ["conv", "linear"])
@pytest.mark.parametrize("T", [40, 47])
def test_discriminator_matches_jax(jax_dropout_off, kind, T):
    """Window scores and the adversarial loss, for a T that is a multiple
    of the window and one that is not (the conv D's overlapping tail
    window; the linear D's clipped windows), the linear D with injected
    overlaps."""
    jhp = tiny_hp(discriminator_type=kind)
    hp = port_hp(jhp)
    rng = np.random.RandomState(T)
    B, M = 3, hp.n_mel_channels
    mel = rng.randn(B, M, T).astype(np.float32)
    lengths = np.array([T, T - 13, 21], np.int32)
    disc = jax_disc.make_discriminator(jhp)
    W = hp.discriminator_window
    init_in = (jnp.zeros((1, 1, W * M)) if kind == "linear"
               else jnp.zeros((B, T, M)))
    params = np_tree(disc.init({"params": jax.random.PRNGKey(3)}, init_in,
                               False))["params"]
    port = disable_dropout(discriminator_from_jax(params, hp, device="cpu"))
    if kind == "linear":
        windows = rng.randn(B, 4, W * M).astype(np.float32)
        j_scores = disc.apply({"params": params}, jnp.asarray(windows),
                              False)
        p_scores = port.scores(torch.from_numpy(windows), False)
        overlaps = rng.randint(0, 7, (B, 8))
        j_loss = disc.apply({"params": params}, jnp.asarray(mel),
                            jnp.asarray(lengths), False,
                            overlaps=jnp.asarray(overlaps),
                            method=disc.adversarial_loss)
        p_loss = port(torch.from_numpy(mel), torch.from_numpy(lengths).long(),
                      False, overlaps=torch.from_numpy(overlaps))
    else:
        x = mel.transpose(0, 2, 1)
        j_scores = disc.apply({"params": params}, jnp.asarray(x), False)
        p_scores = port.scores(torch.from_numpy(x.copy()), False)
        assert port.convs[0].conv.out_channels == 1024
        j_loss = disc.apply({"params": params}, jnp.asarray(mel),
                            jnp.asarray(lengths), False,
                            method=disc.adversarial_loss)
        p_loss = port(torch.from_numpy(mel), torch.from_numpy(lengths).long(),
                      False)
    np.testing.assert_allclose(p_scores.detach().numpy(),
                               np.asarray(j_scores), rtol=1e-5, atol=1e-5)
    rel_close(p_loss, j_loss, 1e-5, "adversarial loss")


def test_linear_discriminator_draws_overlaps_from_its_generator():
    hp = port_hp(tiny_hp(discriminator_type="linear"))
    disc = disable_dropout(make_discriminator(hp, device="cpu"))
    mel = torch.randn(2, hp.n_mel_channels, 60,
                      generator=torch.Generator().manual_seed(0))
    lengths = torch.tensor([60, 41])

    def loss(seed):
        return disc(mel, lengths, True, torch.Generator().manual_seed(seed))

    assert torch.equal(loss(1), loss(1))
    assert not torch.equal(loss(1), loss(2))


def test_gradient_penalty_matches_jax(jax_dropout_off, monkeypatch):
    jhp = tiny_hp()
    hp = port_hp(jhp)
    rng = np.random.RandomState(9)
    B, M, W = 3, hp.n_mel_channels, hp.discriminator_window
    real = rng.randn(B, M, 2 * W).astype(np.float32)
    fake = rng.randn(B, M, 2 * W).astype(np.float32)
    real_len = np.array([40, 31, 25], np.int32)
    fake_len = np.array([33, 40, 12], np.int32)
    disc = jax_disc.make_discriminator(jhp)
    params = np_tree(disc.init({"params": jax.random.PRNGKey(3)},
                               jnp.zeros((B, 2 * W, M)), False))["params"]
    key = jax.random.PRNGKey(5)

    def scores(p, x, k):
        return disc.apply({"params": p}, pad_jax(x).transpose(0, 2, 1), True,
                          rngs={"dropout": k})

    def pad_jax(x):
        return jnp.pad(x, ((0, 0), (0, 0), (0, (-x.shape[2]) % W)))

    j_gp = jax_losses.gradient_penalty(
        scores, params, jnp.asarray(real), jnp.asarray(fake),
        jnp.asarray(real_len), jnp.asarray(fake_len), key)
    alpha = np.array(jax.random.uniform(jax.random.split(key)[0],
                                          (B, 1, 1)))
    monkeypatch.setattr(losses, "interpolation_weights",
                        lambda *a: torch.from_numpy(alpha))
    port = disable_dropout(discriminator_from_jax(params, hp, device="cpu"))
    p_gp = losses.gradient_penalty(
        lambda x: port.scores(pad_mel_to_window(x, W).transpose(1, 2)),
        torch.from_numpy(real), torch.from_numpy(fake),
        torch.from_numpy(real_len).long(), torch.from_numpy(fake_len).long())
    rel_close(p_gp, j_gp, 1e-5, "gradient penalty")


# -- steps --------------------------------------------------------------------
@pytest.mark.parametrize("deferred", [True, False])
def test_g_and_d_step_match_jax(run, run_no_deferred_dw, deferred):
    """One G step then one D step from the same state, with the JAX G step's
    deferred-dW backward on and off: metrics, every updated parameter of
    both models and the BatchNorm running statistics."""
    r = run if deferred else run_no_deferred_dw
    assert r.jhp.deferred_dw is deferred
    p_state, steps = r.port(r.state)
    j_state, p_state = g_and_d_step(r, r.state, p_state, steps)
    assert_states_match(p_state, j_state, r.hp, f"deferred_dw={deferred}")


def test_d_step_with_gradient_penalty_matches_jax(run_gp, monkeypatch):
    r = run_gp
    p_state, (g_step, d_step, _) = r.port(r.state)
    batch = r.port_batch()
    # The fake mels are the G step's, taken on the JAX side only.
    _, _, (j_mel, j_len) = r.g_step(r.state, r.batch, jnp.float32(G_LR),
                                    jnp.float32(ATTN_W))
    j_state, j_m = r.d_step(r.state, r.batch.mels, r.batch.output_lengths,
                            j_mel, j_len, jnp.float32(D_LR))
    k_gp = jax.random.split(r.state.rng, 4)[3]
    alpha = np.array(jax.random.uniform(jax.random.split(k_gp)[0],
                                          (batch.mels.shape[0], 1, 1)))
    monkeypatch.setattr(losses, "interpolation_weights",
                        lambda *a: torch.from_numpy(alpha))
    p_state, p_m = d_step(p_state, batch.mels, batch.output_lengths,
                          torch.from_numpy(np.array(j_mel)),
                          torch.from_numpy(np.array(j_len)).long(), D_LR)
    assert float(p_m["gradient_penalty"]) > 0
    for k in D_METRICS:
        rel_close(p_m[k], j_m[k], 1e-5, k)
    assert_states_match(p_state, j_state, r.hp, "gradient penalty")


def test_second_step_from_a_carried_state_matches_jax(run):
    """A state carried over mid-training (Adam moments, count, BatchNorm
    running statistics, step) gives the same next G and D steps."""
    p_state, steps = run.port(run.state)
    j_state, _ = g_and_d_step(run, run.state, p_state, steps)
    p_state2, steps2 = run.port(j_state)
    assert p_state2.g_opt_state.count == 1 and p_state2.step == 2
    j_state2, p_state2 = g_and_d_step(run, j_state, p_state2, steps2)
    assert_states_match(p_state2, j_state2, run.hp, "second step")


def _mutate(state, kind):
    """Moves one entry of ``state`` by 1e-3 in the place ``kind`` names."""
    names = [n for n, _ in state.g_model.named_parameters()]
    i = next(i for i, n in enumerate(names) if "decoder" in n)
    with torch.no_grad():
        if kind == "count":
            state.step += 1
        elif kind == "stats":
            next(state.g_model.buffers())[0] += 1e-3
        elif kind == "first_moment":
            state.g_opt_state.mu[i][..., 0] += 1e-3
        elif kind == "second_moment":
            state.g_opt_state.nu[i][..., 0] += 1e-3
        elif kind == "param":
            list(state.g_model.parameters())[i][..., 0] += 1e-3
        elif kind == "bn_fed_bias_noise":
            state.g_opt_state.mu[names.index("encoder.convs.0.conv.bias")] \
                += 1e-3


@pytest.mark.parametrize("kind", [None, "count", "stats", "first_moment",
                                  "second_moment", "param",
                                  "bn_fed_bias_noise"])
def test_compare_states_flags_each_kind_of_mismatch(run, kind):
    """The comparison the step tests and the card's parity phase share:
    two states from one JAX state agree exactly, and a 1e-3 move of any
    one thing it holds is refused."""
    state, _ = run.port(run.state)
    ref, _ = run.port(run.state)
    _mutate(state, kind)
    tol = dict(moment_tol=1e-5, param_rtol=1e-5, param_atol=1e-6,
               floor=1e-4, noise_tol=1e-6, stats_tol=1e-6)
    if kind is None:
        worst = compare_states(state, ref, **tol)
        assert all((w[0] if isinstance(w, tuple) else w) == 0
                   for w in worst.values())
    else:
        match = {"count": "counts", "bn_fed_bias_noise": "of the largest"}
        with pytest.raises(AssertionError,
                           match=match.get(kind, rf"\({kind}\)")):
            compare_states(state, ref, **tol)


def test_bf16_step_matches_jax(jax_dropout_off):
    """fp16_run: bfloat16 forward passes over float32 masters; losses and
    grad norms within 2e-2 relative, and the masters stay float32. The
    adversarial losses are signed means of window scores that cancel in
    part, so theirs is 2e-2 of the mean |score| (float32, port)."""
    r = JaxRun(fp16_run=True)
    p_state, (g_step, d_step, _) = r.port(r.state)
    batch = r.port_batch()
    D, W = p_state.d_model, r.hp.discriminator_window

    def score_scale(mel):
        with torch.no_grad():
            x = pad_mel_to_window(mel.float(), W).transpose(1, 2)
            return D.scores(x, False).abs().mean().item()

    style = torch.from_numpy(r.style(r.state, jnp.bfloat16))
    j_state, j_m, (j_mel, j_len) = r.g_step(
        r.state, r.batch, jnp.float32(G_LR), jnp.float32(ATTN_W))
    p_state, p_m, (p_mel, p_len) = g_step(p_state, batch, G_LR, ATTN_W,
                                          style=style)
    fake_scale = score_scale(p_mel)
    for k in G_METRICS:
        if k == "adversarial_loss":
            assert abs(float(p_m[k]) - float(j_m[k])) <= 2e-2 * fake_scale
        else:
            rel_close(p_m[k], j_m[k], 2e-2, k)
    _, j_dm = r.d_step(j_state, r.batch.mels, r.batch.output_lengths, j_mel,
                       j_len, jnp.float32(D_LR))
    real_scale = score_scale(batch.mels)
    _, p_dm = d_step(p_state, batch.mels, batch.output_lengths, p_mel, p_len,
                     D_LR)
    for k, scale in (("real_loss", real_scale), ("fake_loss", fake_scale),
                     ("discriminator_loss", max(real_scale, fake_scale))):
        assert abs(float(p_dm[k]) - float(j_dm[k])) <= 2e-2 * scale, k
    rel_close(p_dm["discriminator_grad_norm"],
              j_dm["discriminator_grad_norm"], 2e-2, "D grad norm")
    assert all(p.dtype == torch.float32
               for p in p_state.g_model.parameters())
    assert all(m.dtype == torch.float32 for m in p_state.g_opt_state.mu)


def test_eval_step_keeps_running_statistics():
    hp = port_hp(tiny_hp())
    batch = synth_batch(tiny_hp())
    state, G, D, g_tx, d_tx = create_train_state(
        hp, 0, Batch(*np_tree(tuple(batch))), device="cpu")
    _, _, eval_step = make_train_steps(hp, G, D, g_tx, d_tx)
    before = [b.clone() for b in G.buffers()]
    metrics, out = eval_step(state, to_device(Batch(*np_tree(tuple(batch))),
                                              "cpu"),
                             torch.Generator().manual_seed(0))
    assert set(metrics) == {"mel_loss", "gate_loss", "attention_loss"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert out[0].shape == batch.mels.shape
    assert all(torch.equal(a, b) for a, b in zip(before, G.buffers()))


# -- guards -------------------------------------------------------------------
GUARDS = [
    (dict(gradient_penalty_lambda=10.0, discriminator_type="linear"),
     NotImplementedError, "linear"),
    (dict(adversarial_rollouts=True, quantized_inference=True),
     NotImplementedError, "quantized_inference"),
    (dict(style_code_dims=99), ValueError, "noise_size"),
    (dict(style_code_levels=1), ValueError, "constant code"),
]


@pytest.mark.parametrize("over,error,match", GUARDS)
def test_make_train_steps_guards_raise(over, error, match):
    hp = port_hp(tiny_hp(**over))
    batch = Batch(*np_tree(tuple(synth_batch(tiny_hp(), B=2))))
    state, G, D, g_tx, d_tx = create_train_state(hp, 0, batch, device="cpu")
    with pytest.raises(error, match=match):
        make_train_steps(hp, G, D, g_tx, d_tx)


_ROLL = dict(adversarial_rollouts=True)
_DIV = dict(_ROLL, diversity_weight=1.0)
IDENTIFICATION_GUARDS = [
    dict(style_reconstruction_weight=1.0),
    dict(_ROLL, style_reconstruction_weight=1.0, use_noise=False,
         noise_size=0),
    dict(diversity_weight=1.0),
    dict(_DIV, use_noise=False, noise_size=0),
    dict(_DIV, factor_rescue_actuator="both"),
    dict(_DIV, factor_rescue_floor=2.0, factor_rescue_actuator="recon",
         diversity_subset_redraw=True, style_code_dims=2),
    dict(_DIV, code_modularity_weight=1.0, style_code_dims=2),
    dict(_DIV, code_additivity_weight=1.0, diversity_cap=0.9,
         style_code_dims=1),
    dict(_ROLL, code_orthogonal_reward=True, diversity_cap=0.9,
         style_code_dims=2),
    dict(_DIV, factor_rescue_floor=2.0, factor_rescue_actuator="redraw",
         style_code_dims=2),
    dict(_DIV, style_code_levels=1),
    dict(_ROLL, quantized_inference=True),
    dict(_DIV, style_reconstruction_weight=1.0, quantized_inference=True),
]


@pytest.mark.parametrize("over", IDENTIFICATION_GUARDS)
def test_identification_guards_raise_as_jax(over):
    """The guards of the identification flags (adversarial rollouts, style
    reconstruction, diversity, the code terms, the factor-aware rescue,
    int8 rollouts): JAX's ``make_train_steps`` and the port's raise the
    same exception with the same message on the same settings."""
    jhp = tiny_hp(**over)
    gen, disc = jax_taco.Tacotron2(jhp), jax_disc.make_discriminator(jhp)
    with pytest.raises((ValueError, NotImplementedError)) as j_err:
        jax_make_steps(jhp, gen, disc, None, None)
    hp = port_hp(jhp)
    batch = Batch(*np_tree(tuple(synth_batch(tiny_hp(), B=2))))
    _, G, D, g_tx, d_tx = create_train_state(hp, 0, batch, device="cpu")
    with pytest.raises(j_err.type) as p_err:
        make_train_steps(hp, G, D, g_tx, d_tx)
    assert str(p_err.value) == str(j_err.value)


def test_train_state_needs_a_k_multiple_and_a_card():
    hp = port_hp(tiny_hp(n_frames_per_step=5))
    batch = Batch(*np_tree(tuple(synth_batch(tiny_hp(), B=2))))
    with pytest.raises(ValueError, match="multiple"):
        create_train_state(hp, 0, batch, device="cpu")
    if not torch.cuda.is_available():
        hp = port_hp(tiny_hp())
        for make in (lambda: create_train_state(hp, 0, batch),
                     lambda: make_discriminator(hp)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
