"""The port's deferred-dW G step (``hp.deferred_dw``, on by default): the
teacher-forced decoder's five big in-loop weights detached, each step's gate
gradient read from a zero-valued offset, and their gradients rebuilt after
the backward (train/step.py ``make_dw_offsets``/``apply_deferred_dw``).

The deferred step against the port's plain step (the same gradients,
reassociated), against the JAX package's deferred step from one JAX state,
in bfloat16, with rollouts (whose weight gradients are the sum of both
paths), and a count of the backward's operations: the per-step weight
products go, and neither the offsets nor the hoisted input projection add
a per-step ``select_backward``.
"""

import collections
import contextlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from gantron_tpu_torch.models.modules import disable_dropout
from gantron_tpu_torch.train.state import BN_FED_BIAS, create_train_state
from gantron_tpu_torch.train.step import (Batch, make_dw_offsets,
                                          make_train_steps, to_device)
from test_torch_identification import (ARM_A, IdentRun,  # noqa: F401
                                       assert_ident_states_match, g_step_both)
from test_torch_train import (ATTN_W, G_LR, G_METRICS, JaxRun,  # noqa: F401
                              assert_states_match, jax_dropout_off, np_tree,
                              port_hp, rel_close)
from test_train_step import synth_batch, tiny_hp
from torch_threads import one_torch_thread  # noqa: F401

# tests/test_deferred_dw.py's bounds on the Adam-updated parameters.
PARAM_TOL = dict(rtol=2e-4, atol=2e-6)
METRIC_TOL = 1e-6


def port_g_step(hp, batch, seed=0):
    """One G step of the port from ``create_train_state(seed)`` (dropout
    on: both flags draw the same masks); returns (state, metrics, fake
    mel)."""
    state, G, D, g_tx, d_tx = create_train_state(hp, seed, batch,
                                                 device="cpu")
    g_step, _, _ = make_train_steps(hp, G, D, g_tx, d_tx)
    state, metrics, (mel, _) = g_step(state, batch, G_LR, ATTN_W)
    return state, metrics, mel


@pytest.mark.parametrize("K", [1, 2])
def test_deferred_matches_plain(K):
    """Deferred against plain, float32: the same forward (fake mel within
    1e-6), losses and grad norm within 1e-6 relative, every updated
    parameter within ``PARAM_TOL``."""
    jhp = tiny_hp(n_frames_per_step=K)
    batch = to_device(Batch(*np_tree(tuple(synth_batch(jhp)))), "cpu")
    runs = {}
    for deferred in (True, False):
        hp = port_hp(jhp)
        hp.deferred_dw = deferred
        runs[deferred] = port_g_step(hp, batch)
    (s_d, m_d, mel_d), (s_p, m_p, mel_p) = runs[True], runs[False]
    np.testing.assert_allclose(mel_d.numpy(), mel_p.numpy(), rtol=0,
                               atol=1e-6)
    for k in ("generator_loss", "mel_loss", "gate_loss", "attention_loss",
              "grad_norm"):
        rel_close(m_d[k], m_p[k], METRIC_TOL, k)
    names = [n for n, _ in s_d.g_model.named_parameters()]
    for n, a, b in zip(names, s_d.g_model.parameters(),
                       s_p.g_model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   err_msg=n, **PARAM_TOL)


def test_deferred_step_matches_jax_deferred_step(jax_dropout_off):
    """The port's deferred G step against JAX's deferred G step from one
    JAX state at K = 2 (test_torch_train.py holds K = 1; dropout off, the
    style injected): every metric within 1e-5 relative and the state at
    ``assert_states_match``'s tolerances."""
    r = JaxRun(n_frames_per_step=2)
    assert r.hp.deferred_dw and r.jhp.deferred_dw
    p_state, (g_step, _, _) = r.port(r.state)
    j_state, j_m, (j_mel, _) = r.g_step(r.state, r.batch, jnp.float32(G_LR),
                                        jnp.float32(ATTN_W))
    p_state, p_m, (p_mel, _) = g_step(
        p_state, r.port_batch(), G_LR, ATTN_W,
        style=torch.from_numpy(r.style(r.state)))
    for k in G_METRICS:
        rel_close(p_m[k], j_m[k], 1e-5, k)
    np.testing.assert_allclose(p_mel.numpy(), np.asarray(j_mel), atol=1e-4)
    assert_states_match(p_state, j_state, r.hp, "deferred, K=2")


def test_deferred_bf16_step_matches_jax(jax_dropout_off):
    """fp16_run with the deferred backward on both sides (bfloat16 offsets,
    the rebuilt gradients summed in float32): the losses and the grad norm
    within test_torch_train.py's 2e-2 relative, the adversarial loss within
    2e-2 of the mean |score| of D on the fake mel, every generator
    parameter moved and still float32."""
    r = JaxRun(fp16_run=True)
    p_state, (g_step, _, _) = r.port(r.state)
    before = [p.detach().clone() for p in p_state.g_model.parameters()]
    j_state, j_m, _ = r.g_step(r.state, r.batch, jnp.float32(G_LR),
                               jnp.float32(ATTN_W))
    p_state, p_m, (p_mel, _) = g_step(
        p_state, r.port_batch(), G_LR, ATTN_W,
        style=torch.from_numpy(r.style(r.state, jnp.bfloat16)))
    with torch.no_grad():
        x = torch.nn.functional.pad(
            p_mel, (0, (-p_mel.shape[2]) % r.hp.discriminator_window))
        scale = p_state.d_model.scores(x.transpose(1, 2), False).abs() \
            .mean().item()
    for k in G_METRICS:
        if k == "adversarial_loss":
            assert abs(float(p_m[k]) - float(j_m[k])) <= 2e-2 * scale
        else:
            rel_close(p_m[k], j_m[k], 2e-2, k)
    names = [n for n, _ in p_state.g_model.named_parameters()]
    for n, a, b in zip(names, p_state.g_model.parameters(), before):
        assert a.dtype == torch.float32, n
        if not BN_FED_BIAS.match(n):
            assert not torch.equal(a.detach(), b), n


@pytest.fixture(scope="module")
def arm_a_run(jax_dropout_off):
    return IdentRun(**ARM_A)


@pytest.mark.parametrize("deferred", [True, False])
def test_rollout_step_with_deferred_matches_jax(arm_a_run, deferred):
    """ARM_A (rollouts, InfoGAN reconstruction, the diversity pair) against
    JAX's deferred step: the rollouts keep plain autograd, so the five
    weights' gradients are autograd's rollout part plus the rebuilt
    teacher-forced part. The port's plain step is held to the same JAX
    step. Metrics within 1e-5 relative, moments at ``ROLLOUT_MOMENT_TOL``."""
    run = arm_a_run
    assert run.jhp.deferred_dw
    hp = port_hp(run.jhp)
    hp.deferred_dw = deferred
    p_state, (g_step, _, _) = run.port(hp=hp)
    j_state, j_m, j_fake, p_state, p_m, p_fake = g_step_both(
        run, p_state, g_step)
    assert "rollout_adversarial_loss" in p_m
    for k in j_m:
        rel_close(p_m[k], j_m[k], 1e-5, k)
    np.testing.assert_array_equal(p_fake[1].numpy(), np.asarray(j_fake[1]))
    assert_ident_states_match(p_state, j_state, hp,
                              f"ARM_A, port deferred_dw={deferred}")


class OpCounter(TorchDispatchMode):
    """Counts every aten op by name, and the input sizes of each
    ``select_backward``."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.select_backward = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.ops[name] += 1
        if name == "select_backward":
            self.select_backward[tuple(args[1])] += 1
        return func(*args, **(kwargs or {}))


class IndexedRows(TorchFunctionMode):
    """``Decoder.forward`` as it took the hoisted projection's per-step
    rows before it unbound them: the ``unbind`` of a (steps, B,
    4 attention_rnn_dim) tensor that is not one of ``keep`` (the offsets)
    returns its rows by indexing, ``x[t]``; counted in ``taken``."""

    def __init__(self, shape, keep=()):
        super().__init__()
        self.shape, self.keep, self.taken = shape, keep, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        x = args[0] if args else None
        if (func is torch.Tensor.unbind and tuple(x.shape) == self.shape
                and not any(x is k for k in self.keep)):
            self.taken += 1
            return tuple(x[t] for t in range(x.shape[0]))
        return func(*args, **(kwargs or {}))


def backward_ops(hp, batch, deferred, indexed=False):
    """The aten ops of the backward of one teacher-forced loss (float32,
    dropout off), counted; the offsets' shapes and the projection's; the
    gradients of every parameter and offset. ``indexed``: the
    projection's rows taken by indexing (``IndexedRows``)."""
    G = create_train_state(hp, 0, batch, device="cpu")[1]
    disable_dropout(G)
    B, T_out = batch.mels.shape[0], batch.mels.shape[2]
    offsets = (make_dw_offsets(hp, B, T_out, torch.float32, "cpu")
               if deferred else None)
    proj = (T_out // hp.n_frames_per_step, B, 4 * hp.attention_rnn_dim)
    rows = IndexedRows(proj, tuple(offsets.values()) if deferred else ())
    with rows if indexed else contextlib.nullcontext():
        out = G(batch.text, batch.text_lengths, batch.mels, batch.speaker,
                batch.emotions, batch.output_lengths, train=True,
                style=torch.zeros(B, 1, G.noise_size), dw_offsets=offsets)
    assert rows.taken == indexed
    if deferred:
        out = out[0]
    loss = out[1].square().mean() + out[2].mean()
    inputs = list(G.parameters()) + (list(offsets.values()) if deferred
                                     else [])
    with OpCounter() as counter:
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    shapes = ({k: tuple(v.shape) for k, v in offsets.items()}
              if deferred else {})
    return counter, {**shapes, "proj": proj}, grads


def test_deferred_backward_drops_the_per_step_weight_products():
    """With the offsets, the backward runs at least 4 x steps fewer
    ``aten.mm`` than the plain one (each step's five weight-gradient
    products go), and no ``select_backward`` beyond the plain backward's:
    the offsets' per-step views are taken by ``unbind``, so no offset's
    gradient is a per-step zero buffer of its whole size. (z1 shares its
    shape with the hoisted input projection ``attn_in_proj``, whose rows
    are unbound too, so neither backward records a ``select_backward`` of
    that shape; the decoder LSTM is 40 wide here so that z2's shape is its
    own.)"""
    jhp = tiny_hp(decoder_rnn_dim=40)
    hp = port_hp(jhp)
    batch = to_device(Batch(*np_tree(tuple(synth_batch(jhp)))), "cpu")
    steps = batch.mels.shape[2] // hp.n_frames_per_step
    deferred, shapes, _ = backward_ops(hp, batch, True)
    plain, _, _ = backward_ops(hp, batch, False)
    assert plain.ops["mm"] - deferred.ops["mm"] >= 4 * steps, (
        plain.ops["mm"], deferred.ops["mm"])
    assert deferred.select_backward == plain.select_backward
    assert deferred.select_backward[shapes["z1"]] == 0
    for k in ("z2", "zq"):
        assert deferred.select_backward[shapes[k]] == 0, k


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("deferred", [True, False])
def test_projection_rows_by_unbind_match_indexing(deferred, K):
    """The teacher-forced loop takes its rows of the hoisted projection
    ``attn_in_proj`` by ``unbind``: its backward records no
    ``select_backward`` of the projection's shape (indexing records one a
    step, each a zero buffer of the whole projection added into its
    gradient), and the gradient of every parameter and offset is
    bit-equal to the one when the rows are taken by indexing: those adds
    summed exact zeros around each row."""
    jhp = tiny_hp(n_frames_per_step=K)
    hp = port_hp(jhp)
    batch = to_device(Batch(*np_tree(tuple(synth_batch(jhp)))), "cpu")
    steps = batch.mels.shape[2] // K
    unbound, shapes, grads = backward_ops(hp, batch, deferred)
    indexed, _, ref = backward_ops(hp, batch, deferred, indexed=True)
    assert unbound.select_backward[shapes["proj"]] == 0
    assert indexed.select_backward[shapes["proj"]] == steps
    assert len(grads) == len(ref)
    for i, (a, b) in enumerate(zip(grads, ref)):
        assert (a is None) == (b is None), i
        assert a is None or torch.equal(a, b), i


def test_flop_counter_counts_the_deferred_step_as_the_plain_one():
    """``cli/bench.py``'s ``count_flops`` (``FlopCounterMode``, whose module
    tracker hooks every module input that requires grad) runs the
    deferred G step: the offsets are copies of leaves, since a gradient
    hook cannot be put on a leaf under ``torch.autograd.grad``. The dW
    products move out of the loop, so the matmul FLOPs are the plain
    step's."""
    from gantron_tpu_torch.cli.bench import count_flops

    jhp = tiny_hp(fp16_run=True)
    batch = to_device(Batch(*np_tree(tuple(synth_batch(jhp, B=2)))), "cpu")
    flops = {}
    for deferred in (True, False):
        hp = port_hp(jhp)
        hp.deferred_dw = deferred
        state, G, D, g_tx, d_tx = create_train_state(hp, 0, batch,
                                                     device="cpu")
        g_step, d_step, _ = make_train_steps(hp, G, D, g_tx, d_tx)
        flops[deferred] = count_flops(g_step, d_step, state, batch, G_LR,
                                      7e-4)
    assert flops[True] == flops[False] and flops[True][0] > 0
