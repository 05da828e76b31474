"""Port parity of the emotion classifier: gantron_tpu_torch's
models/classifier.py, ``classifier_from_jax`` and eval/classifier.py
(``MelCrops``, ``ClassifierTrainer``, save/load) and
eval/inference_classifier.py against the JAX package's, at tiny sizes
(n_mel 16, n_frames 16, model_size 32, batch 8).

Both sides start from the same JAX-initialised variables, carried over with
``classifier_from_jax``. Dropout is the identity on both sides (the JAX
package's ``_dropout`` and the port's ``dropout`` patched), and the port's
crops are injected at the JAX trainer's draws, replayed from its key.

Tolerances: forward logits 1e-5 and BatchNorm statistics 1e-6; crops,
windows of probabilities 1e-6; ``MelCrops`` batches bit-equal. Training
(3 epochs) holds losses and accuracies within 1e-5 relative, parameters
within 1e-5 and BatchNorm running statistics within 1e-4 of their tensor's
largest entry, with two exceptions that Adam makes in both packages alike.
The hidden layers' biases feed a training-mode BatchNorm, so their exact
gradient is 0 and each side would step them by its own float32 noise,
scaled up to the learning rate: here both sides give them their exact
gradient, 0, so they stay 0. And Adam's step g / (sqrt(v) + eps) turns a
rounding of a gradient near eps into up to 2e-2 learning rates (1.9e-5 in
one of the linear variant's 8192 first-layer weights): an entry whose
gradient fell below 100 eps at some step is held to the farthest Adam can
carry it, and the running statistics downstream of it to 1e-4.
"""

import dataclasses
import functools
import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import gantron_tpu.eval.classifier as jec
import gantron_tpu.eval.inference_classifier as jinf
import gantron_tpu.models.classifier as jclf
from gantron_tpu.config import ClassifierHParams as JaxClassifierHParams
from gantron_tpu_torch.config import ClassifierHParams
from gantron_tpu_torch.data.wav import write_wav
from gantron_tpu_torch.eval import classifier as pec
from gantron_tpu_torch.eval import inference_classifier as pinf
from gantron_tpu_torch.models import classifier as pclf
from gantron_tpu_torch.train.state import EPS
from gantron_tpu_torch.utils.jax_weights import classifier_from_jax
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(n_mel_channels=16, n_frames=16, model_size=32, batch_size=8,
            epochs=10, mel_offset=2, max_noise=1)


def tiny_hparams(**over):
    """The same configuration as (JAX ClassifierHParams, port's)."""
    jhp, hp = JaxClassifierHParams(), ClassifierHParams()
    for h in (jhp, hp):
        h.add_params({**TINY, **over})
    return jhp, hp


def _identity_dropout(x, *args, **kw):
    return x


@pytest.fixture(autouse=True)
def no_dropout(monkeypatch):
    monkeypatch.setattr(jclf, "_dropout", _identity_dropout)
    monkeypatch.setattr(pclf, "dropout", _identity_dropout)


@functools.lru_cache(maxsize=None)
def jax_variables(linear, n_mel, n_frames, seed=0):
    """JAX Classifier and its jitted-init variables (numpy leaves), with
    BatchNorm scale/bias/statistics randomised."""
    jhp, hp = tiny_hparams(linear_model=linear, n_mel_channels=n_mel,
                           n_frames=n_frames)
    model = jclf.Classifier(jhp)
    v = jax.tree.map(np.asarray, jax.jit(
        lambda r, x: model.init(r, x, train=False))(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
        np.zeros((1, n_mel, n_frames), np.float32)))
    v = jax.tree.map(np.array, v)  # writeable copies
    rng = np.random.RandomState(seed + 7)
    for name, bn in v["params"].items():
        if name.startswith("bn_"):
            n = bn["scale"].shape[0]
            bn["scale"] = rng.uniform(0.8, 1.2, n).astype(np.float32)
            bn["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
            st = v["batch_stats"][name]
            st["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
            st["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return jhp, hp, model, v


# conv_odd: n_mel != n_frames, neither a multiple of 8, for the pools'
# floors and the flatten order before the head.
CASES = {"linear": (True, 16, 16), "conv": (False, 16, 16),
         "conv_odd": (False, 20, 12)}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_flax(case, train):
    jhp, hp, model, v = jax_variables(*CASES[case])
    x = np.random.RandomState(3).rand(8, hp.n_mel_channels,
                                      hp.n_frames).astype(np.float32)
    port = classifier_from_jax(v, hp, "cpu")
    np.testing.assert_allclose(
        port.predict(torch.from_numpy(x)).numpy(),
        np.asarray(model.apply(v, x, method=model.predict)), atol=1e-6)
    if train:
        j_logits, mut = model.apply(v, x, train=True,
                                    rngs={"dropout": jax.random.PRNGKey(0)},
                                    mutable=["batch_stats"])
    else:
        j_logits = model.apply(v, x, train=False)
    with torch.no_grad():
        p_logits = port(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(j_logits),
                               atol=1e-5, rtol=1e-5)
    if train:
        ref = classifier_from_jax({"params": v["params"],
                                   "batch_stats": jax.tree.map(
                                       np.asarray, mut["batch_stats"])},
                                  hp, "cpu")
        for (name, b), r in zip(port.named_buffers(), ref.buffers()):
            np.testing.assert_allclose(b.numpy(), r.numpy(), atol=1e-6,
                                       rtol=1e-6, err_msg=name)


def test_batchnorm_reduces_every_axis_but_channels():
    """The port's BatchNorm on (B, C), (B, C, T) and (B, C, H, W) against
    flax's over the channel-last transpose."""
    from flax import linen as nn

    from gantron_tpu_torch.models.modules import BatchNorm

    rng = np.random.RandomState(0)
    for shape in [(6, 5), (3, 5, 7), (2, 5, 3, 4)]:
        x = rng.randn(*shape).astype(np.float32) * 2 + 1
        x_last = np.moveaxis(x, 1, -1)
        bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                          epsilon=1e-5)
        v = bn.init(jax.random.PRNGKey(0), x_last)
        y, mut = bn.apply(v, x_last, mutable=["batch_stats"])
        port = BatchNorm(5)
        out = port(torch.from_numpy(x), train=True)
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.moveaxis(np.asarray(y), -1, 1),
                                   atol=1e-6)
        np.testing.assert_allclose(port.running_mean.numpy(),
                                   mut["batch_stats"]["mean"], atol=1e-7)
        np.testing.assert_allclose(port.running_var.numpy(),
                                   mut["batch_stats"]["var"], atol=1e-7)


def test_crop_batch_matches_jax():
    """Injected starts (some past T - n_frames) against JAX's
    ``dynamic_slice``, and JAX's own random crops against the port's crops
    at the starts JAX drew."""
    rng = np.random.RandomState(1)
    mels = rng.randn(6, 4, 40).astype(np.float32)
    lengths = np.array([40, 35, 16, 20, 3, 28], np.int32)
    starts = np.array([0, 24, 25, 31, 7, 12])
    want = jax.vmap(lambda m, s: jax.lax.dynamic_slice(m, (0, s), (4, 16)))(
        mels, starts)
    got = pclf.crop_batch(torch.from_numpy(mels), lengths, 16, 2,
                          starts=starts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    key = jax.random.PRNGKey(5)
    jax_crops = jclf.crop_batch(key, mels, lengths, 16, 2)
    drawn = jax.vmap(lambda k, n: jclf.random_crop_start(k, n, 16, 2))(
        jax.random.split(key, 6), lengths)
    np.testing.assert_array_equal(
        pclf.crop_batch(torch.from_numpy(mels), lengths, 16, 2,
                        starts=np.asarray(drawn)).numpy(),
        np.asarray(jax_crops))


def test_random_crop_start_range_matches_jax():
    lengths = np.array([5, 15, 16, 17, 18, 20, 30, 80, 200])
    for n_frames, mel_offset in [(16, 0), (16, 3), (8, 20)]:
        draw = jax.jit(jax.vmap(jax.vmap(
            functools.partial(jclf.random_crop_start, n_frames=n_frames,
                              mel_offset=mel_offset),
            in_axes=(0, None)), in_axes=(None, 0)))
        keys = jax.random.split(jax.random.PRNGKey(n_frames + mel_offset),
                                3000)
        j = np.asarray(draw(keys, jnp.asarray(lengths)))  # (lengths, keys)
        lo, span = pclf.crop_range(lengths, n_frames, mel_offset)
        np.testing.assert_array_equal(j.min(1), lo)
        np.testing.assert_array_equal(j.max(1), lo + span - 1)
        g = torch.Generator().manual_seed(0)
        p = np.stack([pclf.random_crop_start(lengths, n_frames, mel_offset,
                                             g) for _ in range(3000)], 1)
        np.testing.assert_array_equal(p.min(1), lo)
        np.testing.assert_array_equal(p.max(1), lo + span - 1)


@pytest.mark.parametrize("T", [10, 32, 37])
def test_sliding_window_probs_matches_jax(T):
    jhp, hp, model, v = jax_variables(True, 16, 16)
    mel = np.random.RandomState(T).rand(2, 16, T).astype(np.float32)

    def apply_fn(variables, crops):
        return model.apply(variables, crops, method=model.predict)

    want = jclf.sliding_window_probs(apply_fn, v, jnp.asarray(mel), 16)
    port = classifier_from_jax(v, hp, "cpu")
    got = pclf.sliding_window_probs(port.predict, torch.from_numpy(mel), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def synth_dataset(root, n=24, n_mel=16, n_classes=2, seed=0):
    """Class-separable synthetic dB mels of 20-39 frames saved as .npy."""
    rng = np.random.RandomState(seed)
    paths, labels = [], []
    band = n_mel // n_classes
    for i in range(n):
        cls = i % n_classes
        mel = rng.randn(n_mel, rng.randint(20, 40)) * 2 - 70
        mel[cls * band:(cls + 1) * band] += 55
        p = os.path.join(str(root), f"{i}.npy")
        np.save(p, np.clip(mel, -80, 0).astype(np.float32))
        paths.append(p)
        label = np.zeros(5, np.float32)
        label[cls] = 1
        labels.append(label)
    return paths, labels


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return synth_dataset(tmp_path_factory.mktemp("mels"))


@pytest.mark.parametrize("n,kw", [
    (24, dict(batch_size=8, pad_to=18)),
    (24, dict(batch_size=8, shuffle=False, drop_last=False)),
    (5, dict(batch_size=8, pad_to=120)),
])
def test_melcrops_batches_bit_equal(dataset, n, kw):
    paths, labels = dataset
    j = jec.MelCrops(paths[:n], labels[:n], 2, 1, seed=4)
    p = pec.MelCrops(paths[:n], labels[:n], 2, 1, seed=4)
    for epoch in range(2):
        jb, pb = list(j.batches(**kw)), list(p.batches(**kw))
        assert len(jb) == len(pb) > 0
        for a, b in zip(jb, pb):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


class JaxCropReplay:
    """The JAX trainer's crop starts, replayed from its key: one split a
    batch, the training step splitting its key once more for the crops."""

    def __init__(self, seed, hp):
        self.key = jax.random.PRNGKey(seed)
        self.draw = jax.jit(jax.vmap(functools.partial(
            jclf.random_crop_start, n_frames=hp.n_frames,
            mel_offset=hp.mel_offset)))

    def __call__(self, lengths, T, train):
        self.key, sub = jax.random.split(self.key)
        key = jax.random.split(sub)[0] if train else sub
        return np.asarray(self.draw(jax.random.split(key, len(lengths)),
                                    jnp.asarray(lengths)))


def _bn_fed(params):
    return {k: ({"kernel": False, "bias": True}
                if k.startswith(("dense_", "conv_")) else
                jax.tree.map(lambda _: False, v)) for k, v in params.items()}


# The JAX trainer's optax with the hidden layers' bias gradients set to
# their exact value, 0 (module docstring).
JAX_OPTAX = types.SimpleNamespace(
    chain=lambda *t: optax.chain(optax.masked(optax.set_to_zero(), _bn_fed),
                                 *t),
    add_decayed_weights=optax.add_decayed_weights,
    scale_by_adam=optax.scale_by_adam, apply_updates=optax.apply_updates)


# Both variants and both losses (BCE for 'intended', MSE for 'multi').
TRAIN_CASES = {"linear-intended": (True, "intended"),
               "conv-multi": (False, "multi")}


@functools.lru_cache(maxsize=None)
def trained_pair(case, paths, labels):
    """(JAX trainer, port trainer, JAX history, port history) after 3
    epochs from the same variables."""
    linear, use_labels = TRAIN_CASES[case]
    jhp, hp = tiny_hparams(linear_model=linear, use_labels=use_labels)
    labels = [np.asarray(x) for x in labels]
    if use_labels == "multi":  # soft labels
        labels = [0.8 * x + 0.05 for x in labels]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jec, "optax", JAX_OPTAX)
        mp.setattr(jclf, "_dropout", _identity_dropout)
        jt = jec.ClassifierTrainer(jhp, seed=3)
        jt._init(np.zeros((1, 16, 16), np.float32))
        start = jax.tree.map(np.asarray, jt.variables)
        j_hist = jt.fit(jec.MelCrops(paths, labels, 2, 1, seed=1),
                        jec.MelCrops(paths[:10], labels[:10], 2, 1, seed=2),
                        epochs=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pclf, "dropout", _identity_dropout)
        pt = pec.exact_bn_fed_gradients(pec.ClassifierTrainer(
            hp, seed=3, device="cpu",
            model=classifier_from_jax(start, hp, "cpu"),
            crop_starts=JaxCropReplay(3, hp)))
        p_hist = pt.fit(pec.MelCrops(paths, labels, 2, 1, seed=1),
                        pec.MelCrops(paths[:10], labels[:10], 2, 1, seed=2),
                        epochs=3)
    return jt, pt, j_hist, p_hist


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_trainer_matches_jax(dataset, case):
    paths, labels = dataset
    jt, pt, j_hist, p_hist = trained_pair(case, tuple(paths),
                                          tuple(map(tuple, labels)))
    assert len(p_hist) == len(j_hist) == 3
    for j, p in zip(j_hist, p_hist):
        assert j.keys() == p.keys()
        for k in j:
            np.testing.assert_allclose(p[k], j[k], rtol=1e-5, atol=0,
                                       err_msg=f"{case} {k}")
    _, hp = tiny_hparams(linear_model=TRAIN_CASES[case][0])
    ref = classifier_from_jax(jax.tree.map(np.asarray, jt.variables), hp,
                              "cpu")
    adam = next(st for st in jt.opt_state if hasattr(st, "mu"))
    assert pt.opt_state.count == int(adam.count) == 9
    steps = pt.opt_state.count
    for (name, a), b in zip(pt.model.state_dict().items(),
                            ref.state_dict().values()):
        a, b = a.numpy(), b.numpy()
        if pclf.BN_FED_BIAS.match(name):
            assert not a.any() and not b.any(), name
        elif name in pt.min_abs_grad:
            # Adam's step g / (sqrt(v) + eps) moves by eps * dg / (|g| +
            # eps)^2 for a rounding dg of g: below 1e-4 of a step wherever
            # |g| >= 100 eps. Entries whose gradient fell below that at some
            # step are held to the farthest Adam can carry them.
            held = pt.min_abs_grad[name].numpy() >= 100 * EPS
            assert held.mean() > 0.95, (name, held.mean())
            np.testing.assert_allclose(a[held], b[held], rtol=0, atol=1e-5,
                                       err_msg=f"{case} {name}")
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=2 * pt.hp.lr * steps,
                                       err_msg=f"{case} {name}")
        else:  # BatchNorm running statistics
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-4 * np.abs(b).max(),
                                       err_msg=f"{case} {name}")


def test_save_load_round_trip_and_hparams_json(dataset, tmp_path):
    paths, labels = dataset
    jt, pt, _, _ = trained_pair("conv-multi", tuple(paths),
                                tuple(map(tuple, labels)))
    path = str(tmp_path / "clf.pt")
    pt.save(path)
    back = pec.ClassifierTrainer.load(path, device="cpu")
    assert back.hp == pt.hp
    for (name, a), b in zip(pt.model.state_dict().items(),
                            back.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert back.opt_state.count == pt.opt_state.count
    for a, b in zip(pt.opt_state.mu + pt.opt_state.nu,
                    back.opt_state.mu + back.opt_state.nu):
        assert torch.equal(a, b)
    jt.save(str(tmp_path / "jax_clf"))
    with open(path + ".hparams.json") as f, \
            open(str(tmp_path / "jax_clf") + ".hparams.json") as g:
        assert f.read() == g.read()
    # predict_probs at the JAX trainer's next crops.
    mels, lengths, _ = next(pec.MelCrops(paths[:4], labels[:4]).batches(
        4, shuffle=False))
    back.crop_starts = JaxCropReplay(0, back.hp)
    back.crop_starts.key = jt.rng
    np.testing.assert_allclose(back.predict_probs(mels, lengths),
                               jt.predict_probs(mels, lengths), atol=1e-5)


def test_fit_and_evaluate_on_empty_data(tmp_path):
    _, hp = tiny_hparams()
    trainer = pec.ClassifierTrainer(hp, device="cpu")
    empty = pec.MelCrops([], [])
    with pytest.raises(ValueError, match="zero batches"):
        trainer.fit(empty, epochs=1)
    record = trainer.evaluate(empty, prefix="test_")
    assert record["test_empty"] is True and record["test_acc"] == 0.0
    assert np.isnan(record["test_loss"])


def test_inference_from_path_matches_jax(tmp_path):
    jhp, hp, model, v = jax_variables(True, 16, 16)
    # A short STFT keeps the JAX side's eager ops cheap.
    jhp, hp = (dataclasses.replace(h, n_ftt=256, hop_length=64)
               for h in (jhp, hp))
    rng = np.random.RandomState(0)
    t = np.arange(11025) / 22050
    wav = (0.3 * np.sin(2 * np.pi * 440 * t)
           + 0.05 * rng.randn(t.size)).astype(np.float32)
    path = str(tmp_path / "a.wav")
    write_wav(path, wav)
    j_probs, j_name = jinf.inference_from_path(model, v, path, jhp)
    p_probs, p_name = pinf.inference_from_path(
        classifier_from_jax(v, hp, "cpu"), path, hp)
    np.testing.assert_allclose(p_probs, j_probs, atol=1e-5)
    assert p_name == j_name
    for name, dataset_name in [("sa01.wav", "SAVEE"), ("h02.wav", "SAVEE"),
                               ("1001_DFA_ANG_XX.wav", "CREMA-D")]:
        assert pinf.decode_ground_truth(name, dataset_name) == \
            jinf.decode_ground_truth(name, dataset_name)
    with pytest.raises(ValueError):
        pinf.decode_ground_truth("x.wav", "TESS")
