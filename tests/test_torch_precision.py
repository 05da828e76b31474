"""The float32 precision of the port's conv -> BatchNorm stacks: the
explicit-product convolution (``ops/conv.py``), the audit helpers
(``utils/precision.py``) and the float64 training step they compare
against, at tiny sizes on the CPU.

Tolerances: ``ProductConv`` against ``F.conv1d`` / ``F.conv2d`` 1e-12 of
the largest entry in float64 and 1e-5 in float32 (forward, data gradient,
weight gradient). Float32 gradients of the classifier's conv variant and
of a tiny Tacotron2's teacher-forced pass against float64, in every audit
setting: ``F32_VS_F64`` of each tensor's largest entry (the CPU reads
≈ 1e-6). The modules, their convs on the product route, against the JAX
package's, through the weight bridge: outputs 1e-4 (1e-5 for the
classifier's logits), gradients within 1e-5 of themselves plus 1e-5 of
their tensor's largest (``assert_states_match``'s first-moment tolerance
in ``tests/test_torch_train.py``), the conv biases before a training
BatchNorm (exact gradient 0, float32 noise on both sides) left out.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

import gantron_tpu.models.classifier as jclf
import gantron_tpu.models.tacotron2 as jax_taco
from gantron_tpu_torch.config import ClassifierHParams, HParams
from gantron_tpu_torch.models import classifier as pclf
from gantron_tpu_torch.models.classifier import (BN_FED_BIAS as CLF_BN_FED,
                                                 make_classifier)
from gantron_tpu_torch.models.modules import BatchNorm, disable_dropout
from gantron_tpu_torch.models.tacotron2 import Tacotron2
from gantron_tpu_torch.ops import conv as conv_mod
from gantron_tpu_torch.ops.conv import ProductConv, conv
from gantron_tpu_torch.train.state import BN_FED_BIAS, create_train_state
from gantron_tpu_torch.train.step import Batch, make_train_steps, to_device
from gantron_tpu_torch.utils.jax_weights import (classifier_from_jax,
                                                 tacotron2_from_jax)
from gantron_tpu_torch.utils.precision import (audit_setting, audit_settings,
                                               bn_fed_convs,
                                               captured_gradients,
                                               error_shares, to_float64)
from test_torch_classifier import jax_variables as clf_variables
from test_torch_tacotron2 import (_randomise_bn,  # noqa: F401
                                  no_jax_dropout, tiny_hparams)
from torch_threads import one_torch_thread  # noqa: F401

F32_VS_F64 = 1e-4
GRAD_TOL = 1e-5



def _close_grads(port, ref, what):
    """Each tensor within GRAD_TOL of itself plus GRAD_TOL of its
    largest."""
    for n, g in port.items():
        r = ref[n]
        bound = GRAD_TOL * r.abs() + GRAD_TOL * r.abs().max()
        assert bool(((g - r).abs() <= bound).all()), (
            what, n, (g - r).abs().max().item(), r.abs().max().item())


# -- the product route --------------------------------------------------------

# (x shape, weight shape, padding, dilation): the encoder's and postnet's
# "same" 1-D convs, a dilated one, the classifier's 3x3 SAME conv on one
# input channel and on several, and an odd-sized image.
CONVS = [((3, 7, 19), (5, 7, 5), 2, 1), ((2, 6, 23), (4, 6, 5), 4, 2),
         ((2, 1, 8, 8), (4, 1, 3, 3), 1, 1), ((2, 3, 9, 11), (4, 3, 3, 3),
                                               1, 1)]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("shapes", CONVS, ids=lambda s: f"{len(s[1])-2}d")
def test_product_conv_matches_conv(shapes, dtype, tol):
    """Forward, data gradient, weight gradient and bias gradient."""
    xs, ws, padding, dilation = shapes
    rng = np.random.RandomState(0)
    x, w, b = (torch.tensor(rng.randn(*s), dtype=dtype, requires_grad=True)
               for s in (xs, ws, ws[:1]))
    fn = F.conv1d if len(ws) == 3 else F.conv2d
    ref = fn(x, w, b, padding=padding, dilation=dilation)
    got = ProductConv.apply(x, w, b, padding, dilation)
    assert got.shape == ref.shape
    dy = torch.tensor(rng.randn(*ref.shape), dtype=dtype)
    for a, r in zip((got,) + torch.autograd.grad(got, (x, w, b), dy),
                    (ref,) + torch.autograd.grad(ref, (x, w, b), dy)):
        assert (a - r).abs().max() <= tol * r.abs().max()


def test_conv_routes_by_dtype_autograd_and_batch_statistics(monkeypatch):
    """``conv`` takes ``ProductConv`` for float32 under autograd and
    ``F.conv*d`` otherwise (bfloat16, no autograd); only the convs before
    a BatchNorm in training mode reach it: a pass on running statistics
    (inference, a rollout) stays on ``F.conv*d``."""
    x = torch.randn(2, 4, 9, requires_grad=True)
    w = torch.randn(3, 4, 5, requires_grad=True)
    assert conv_mod.use_product(x)
    assert not conv_mod.use_product(x.bfloat16())
    with torch.no_grad():
        assert not conv_mod.use_product(x)
    calls = []
    real = ProductConv.apply
    monkeypatch.setattr(ProductConv, "apply",
                        lambda *a: calls.append(1) or real(*a))
    assert torch.allclose(conv(x, w, None, 2), F.conv1d(x, w, padding=2),
                          atol=1e-5) and calls == [1]
    conv(x.bfloat16(), w.bfloat16(), None, 2)
    assert calls == [1]
    hp = _tiny_taco_hp()
    batch, style = _taco_batch(hp)
    model = disable_dropout(Tacotron2(hp, device="cpu", seed=0))
    names = [n for n, _ in bn_fed_convs(model)]
    assert names == [f"encoder.convs.{i}" for i in range(2)] + [
        f"postnet.convs.{i}" for i in range(3)]
    b = to_device(batch, "cpu")
    for train, expect in ((True, 5), (False, 0)):
        calls.clear()
        model(b.text, b.text_lengths, b.mels, b.speaker, b.emotions,
              b.output_lengths, train=train, style=style)
        assert len(calls) == expect, train
    hp = ClassifierHParams.create("linear_model=False,model_size=8,"
                                  "n_mel_channels=16,n_frames=16")
    clf = make_classifier(hp, "cpu")
    assert [n for n, _ in bn_fed_convs(clf)] == [f"layers.{i}"
                                                for i in range(4)]
    for train, expect in ((True, 4), (False, 0)):
        calls.clear()
        clf(torch.randn(2, 16, 16), train=train)
        assert len(calls) == expect, train


# -- the audit helpers --------------------------------------------------------

def _clf_grads(hp, dtype, setting, crops, labels):
    model = make_classifier(hp, "cpu", seed=0).to(dtype)
    model.train_dropout = False
    named = [(n, p) for n, p in model.named_parameters()
             if not CLF_BN_FED.match(n)]
    with audit_setting(model, setting):
        logits = model(crops.to(dtype), train=True)
        loss = -(F.log_softmax(logits, -1) * labels.to(dtype)).sum(-1).mean()
        grads = torch.autograd.grad(loss, [p for _, p in named])
    return {n: g for (n, _), g in zip(named, grads)}


def test_classifier_audit_float32_near_float64():
    """The conv classifier's float32 gradients against float64 in every
    audit setting, within F32_VS_F64 of each tensor's largest."""
    hp = ClassifierHParams.create("linear_model=False,model_size=8,"
                                  "n_mel_channels=16,n_frames=16,"
                                  "batch_size=4")
    rng = np.random.RandomState(0)
    crops = torch.from_numpy(rng.randn(4, 16, 16).astype(np.float32))
    labels = torch.eye(hp.n_emotions)[rng.randint(0, hp.n_emotions, 4)]
    ref = _clf_grads(hp, torch.float64, "shipped", crops, labels)
    settings = audit_settings(make_classifier(hp, "cpu"))
    assert len(settings) == 6 + 4 * 3
    for setting in settings + ["product"]:
        shares = error_shares(_clf_grads(hp, torch.float32, setting, crops,
                                         labels), ref)
        assert max(shares.values()) <= F32_VS_F64, (setting, shares)
    # A float64 conv gives float64 gradients to that conv's weight.
    shares = error_shares(_clf_grads(hp, torch.float32, "layers.3:float64",
                                     crops, labels), ref)
    assert shares["layers.3.weight"] <= 1e-6, shares
    with pytest.raises(ValueError):
        with audit_setting(make_classifier(hp, "cpu"), "layers.9:float64"):
            pass


def _tiny_taco_hp():
    return HParams.create(
        "use_noise=True,use_labels=False,symbols_embedding_dim=32,"
        "encoder_embedding_dim=32,encoder_n_convolutions=2,"
        "attention_rnn_dim=48,decoder_rnn_dim=48,prenet_dim=16,"
        "attention_dim=24,attention_location_n_filters=4,"
        "postnet_embedding_dim=32,postnet_n_convolutions=3,noise_size=8,"
        "discriminator_dim=32")


def _taco_batch(hp, B=3, T_in=9, T_out=12, seed=4):
    rng = np.random.RandomState(seed)
    text_lengths = np.array([T_in, 5, 7][:B], np.int32)
    output_lengths = np.array([T_out, 7, 10][:B], np.int32)
    text = np.zeros((B, T_in), np.int32)
    mels = (rng.randn(B, hp.n_mel_channels, T_out) * 1.5 - 6).astype(
        np.float32)
    gate = np.zeros((B, T_out), np.float32)
    for b in range(B):
        text[b, :text_lengths[b]] = rng.randint(1, hp.n_symbols,
                                                text_lengths[b])
        mels[b, :, output_lengths[b]:] = 0
        gate[b, output_lengths[b] - 1:] = 1
    style = rng.rand(B, 1, hp.noise_size).astype(np.float32)
    return (Batch(text, text_lengths, mels, gate, np.zeros(B, np.int32),
                  np.zeros((B, 5), np.float32), output_lengths),
            torch.from_numpy(style))


def _g_grads(hp, batch, style, dtype, setting="shipped"):
    """One G step's gradients (before the all-reduce) of a fresh state in
    ``dtype``, dropout off."""
    state, G, D, g_tx, d_tx = create_train_state(hp, 0, batch, "cpu")
    if dtype == torch.float64:
        to_float64(state, g_tx, d_tx)
    disable_dropout(G)
    disable_dropout(D)
    g_step = make_train_steps(hp, G, D, g_tx, d_tx)[0]
    with audit_setting(G, setting), captured_gradients() as calls:
        g_step(state, to_device(batch, "cpu"), 1e-3, 10.0,
               style=style.to(dtype))
    before, after = calls[0]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    return {n: g.double() for (n, _), g in zip(G.named_parameters(), before)
            if not BN_FED_BIAS.match(n)}


def test_float64_step_and_tacotron_audit():
    """A float64 state steps in float64 (gradients, moments, BatchNorm
    statistics); the float32 G step's gradients sit within F32_VS_F64 of
    its gradients in the audit's settings (cuDNN's route and one conv in
    float64 of each stack: the others are the same code on the CPU)."""
    hp = _tiny_taco_hp()
    batch, style = _taco_batch(hp)
    state, G, D, g_tx, d_tx = create_train_state(hp, 0, batch, "cpu")
    to_float64(state, g_tx, d_tx)
    assert {p.dtype for p in G.parameters()} == {torch.float64}
    assert {m.dtype for m in state.g_opt_state.mu} == {torch.float64}
    ref = _g_grads(hp, batch, style, torch.float64)
    assert {g.dtype for g in ref.values()} == {torch.float64}
    for setting in ("shipped", "cudnn", "product", "product32", "bn64",
                    "encoder.convs.1:dgrad64", "postnet.convs.0:wgrad64",
                    "postnet.convs.2:float64"):
        shares = error_shares(_g_grads(hp, batch, style, torch.float32,
                                       setting), ref)
        assert max(shares.values()) <= F32_VS_F64, (setting, max(
            shares, key=shares.get), max(shares.values()))


def test_batchnorm_computes_in_float64_for_float64_input():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(3, 4, 7) * 2 + 5)
    bn = BatchNorm(4)
    y = bn(x, train=True)
    assert y.dtype == torch.float64
    mean = x.mean(dim=(0, 2), keepdim=True)
    var = x.var(dim=(0, 2), unbiased=False, keepdim=True)
    expect = (x - mean) / torch.sqrt(var + 1e-5)
    assert (y - expect).abs().max() < 1e-12
    assert bn.running_mean.dtype == torch.float32


# -- the product route against the JAX package --------------------------------

def test_routed_classifier_matches_jax(monkeypatch):
    """The conv variant's train-mode logits and parameter gradients, its
    convs on the product route, against ``jax.grad`` of the Flax
    classifier."""
    monkeypatch.setattr(jclf, "_dropout", lambda x, *a, **k: x)
    monkeypatch.setattr(pclf, "dropout", lambda x, *a, **k: x)
    jhp, hp, model, v = clf_variables(False, 16, 16)
    rng = np.random.RandomState(3)
    x = rng.rand(8, hp.n_mel_channels, hp.n_frames).astype(np.float32)
    r = rng.randn(8, hp.n_emotions).astype(np.float32)

    def loss(params):
        logits, _ = model.apply({"params": params,
                                 "batch_stats": v["batch_stats"]}, x,
                                train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
        return jnp.sum(logits * r), logits

    (_, j_logits), j_grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"])
    port = classifier_from_jax(v, hp, "cpu")
    p_logits = port(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(p_logits.detach().numpy(),
                               np.asarray(j_logits), atol=1e-5, rtol=1e-5)
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad((p_logits * torch.from_numpy(r)).sum(),
                                params)
    ref = classifier_from_jax({"params": jax.tree.map(np.asarray, j_grads),
                               "batch_stats": v["batch_stats"]}, hp, "cpu")
    _close_grads({n: g for n, g in zip(names, grads)
                  if not CLF_BN_FED.match(n)},
                 {n: p.detach() for n, p in ref.named_parameters()},
                 "classifier")


def jax_tacotron2_variables(jhp):
    """``test_torch_tacotron2.jax_variables``' weights, initialised under
    ``jax.jit`` (an eager init costs seconds of per-primitive compiles)."""
    model = jax_taco.Tacotron2(jhp)
    B, T = 2, 8
    v = jax.jit(lambda keys: model.init(
        keys, jnp.ones((B, T), jnp.int32), jnp.full((B,), T, jnp.int32),
        jnp.zeros((B, jhp.n_mel_channels, 4)), jnp.zeros((B,), jnp.int32),
        jnp.zeros((B, 5)), jnp.full((B,), 4, jnp.int32), train=False))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "noise": jax.random.PRNGKey(2)})
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    _randomise_bn(v["params"], v["batch_stats"], np.random.RandomState(5))
    return v


def test_routed_tacotron2_matches_jax(no_jax_dropout):
    """The teacher-forced pass in training mode (the encoder's and
    postnet's convs on the product route) and its parameter gradients
    against ``jax.grad`` of JAX's Tacotron2."""
    jhp, hp = tiny_hparams()
    v = jax_tacotron2_variables(jhp)
    batch, style = _taco_batch(hp)
    B, T_out = batch.mels.shape[0], batch.mels.shape[2]
    rng = np.random.RandomState(6)
    weights = [rng.randn(B, hp.n_mel_channels, T_out).astype(np.float32),
               rng.randn(B, hp.n_mel_channels, T_out).astype(np.float32),
               rng.randn(B, T_out).astype(np.float32)]
    model = jax_taco.Tacotron2(jhp)

    def loss(params):
        out, _ = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(batch.text), jnp.asarray(batch.text_lengths),
            jnp.asarray(batch.mels), jnp.zeros((B,), jnp.int32),
            jnp.zeros((B, 5)), jnp.asarray(batch.output_lengths),
            train=True, style=jnp.asarray(style.numpy()),
            rngs={"dropout": jax.random.PRNGKey(1)},
            mutable=["batch_stats"])
        return sum(jnp.sum(o * w) for o, w in zip(out, weights)), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    port = disable_dropout(tacotron2_from_jax(v["params"], v["batch_stats"],
                                              hp, device="cpu"))
    p_out = port(torch.from_numpy(batch.text).long(),
                 torch.from_numpy(batch.text_lengths).long(),
                 torch.from_numpy(batch.mels),
                 torch.zeros(B, dtype=torch.long),
                 torch.zeros(B, 5),
                 torch.from_numpy(batch.output_lengths).long(), train=True,
                 style=style)
    for name, a, b in zip(("mel", "mel_postnet", "gate"), p_out, j_out):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-4, err_msg=name)
    names, params = zip(*port.named_parameters())
    total = sum((o * torch.from_numpy(w)).sum()
                for o, w in zip(p_out, weights))
    grads = torch.autograd.grad(total, params)
    ref = tacotron2_from_jax(jax.tree.map(np.asarray, j_grads),
                             v["batch_stats"], hp, device="cpu")
    _close_grads({n: g for n, g in zip(names, grads)
                  if not BN_FED_BIAS.match(n)},
                 {n: p.detach() for n, p in ref.named_parameters()},
                 "tacotron2")
