"""Port parity of the controllability study and the classifier CLIs:
gantron_tpu_torch's eval/study.py (``group_labels_from_paths``,
``split_train_val_test``, ``train_group_classifier``, ``study_model``) and
the ``classifier``, ``inference_classifier`` and ``study_model`` CLIs.

``train_group_classifier`` runs on both sides from the same .npy files, with
dropout off, the port's crops replayed from the JAX trainer's key, the
hidden layers' biases given their exact gradient, 0 (tests/
test_torch_classifier.py says why), and the gradient entries that fall
below Adam's conditioning zeroed on both sides at the steps JAX's run finds
them (``SmallGradientReplay`` says why): history and test metrics within
1e-5 relative. ``study_model`` runs end to end on a tiny port generator with
Griffin-Lim, as tests/test_study.py runs the JAX one: the same files and
metric keys.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import gantron_tpu.eval.classifier as jec
import gantron_tpu.eval.study as jstudy
import gantron_tpu.models.classifier as jclf
from gantron_tpu.config import ClassifierHParams as JaxClassifierHParams
from gantron_tpu_torch.cli import classifier as classifier_cli
from gantron_tpu_torch.cli import inference_classifier as inference_cli
from gantron_tpu_torch.cli import study_model as study_cli
from gantron_tpu_torch.config import HParams
from gantron_tpu_torch.data.toy import synth_emotive_utterance
from gantron_tpu_torch.data.wav import write_wav
from gantron_tpu_torch.eval import classifier as pec
from gantron_tpu_torch.eval import study as pstudy
from gantron_tpu_torch.models import classifier as pclf
from gantron_tpu_torch.models.tacotron2 import Tacotron2
from gantron_tpu_torch.train.state import EPS, Optimizer
from gantron_tpu_torch.utils.jax_weights import classifier_from_jax
from test_torch_classifier import (JAX_OPTAX, JaxCropReplay,
                                   _identity_dropout, tiny_hparams)
from torch_threads import one_torch_thread  # noqa: F401

# tests/test_eval.py::_tiny_generator's configuration, with a short STFT
# for Griffin-Lim and the features.
TINY_GENERATOR = dict(
    symbols_embedding_dim=32, encoder_embedding_dim=32,
    encoder_n_convolutions=2, attention_rnn_dim=48, decoder_rnn_dim=48,
    prenet_dim=16, attention_dim=24, attention_location_n_filters=4,
    attention_location_kernel_size=7, postnet_embedding_dim=32,
    postnet_n_convolutions=3, noise_size=8, discriminator_dim=32,
    max_decoder_steps=24, use_noise=True, use_labels=False, scan_unroll=2,
    filter_length=256, hop_length=64, win_length=256)


def group_files(root, n_groups=2, per=10, seed=0):
    """'g-i.npy' dB mels (16 bins, 20-39 frames) whose group lifts a band."""
    rng = np.random.RandomState(seed)
    paths = []
    for g in range(n_groups):
        for i in range(per):
            mel = rng.randn(16, rng.randint(20, 40)) * 2 - 70
            mel[g * 8:(g + 1) * 8] += 55
            p = os.path.join(str(root), f"{g}-{i}.npy")
            np.save(p, np.clip(mel, -80, 0).astype(np.float32))
            paths.append(p)
    return paths


def test_group_labels_and_split_match_jax(tmp_path):
    paths = group_files(tmp_path, n_groups=3, per=7)
    labels = pstudy.group_labels_from_paths(paths, 3)
    np.testing.assert_array_equal(labels,
                                  jstudy.group_labels_from_paths(paths, 3))
    for got, want in zip(pstudy.split_train_val_test(paths, labels, seed=5),
                         jstudy.split_train_val_test(paths, labels, seed=5)):
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


class JaxStartTrainer(pec.ClassifierTrainer):
    """The port's trainer from the variables the JAX trainer initialises
    for the same hparams (``_init``: params key 0), with the hidden layers'
    biases given their exact gradient."""

    def __init__(self, hp, seed=0, device="cpu", crop_starts=None):
        jhp = JaxClassifierHParams(**hp.as_dict())
        jt = jec.ClassifierTrainer(jhp)
        jt._init(np.zeros((1, hp.n_mel_channels, hp.n_frames), np.float32))
        model = classifier_from_jax(jax.tree.map(np.asarray, jt.variables),
                                    hp, device)
        super().__init__(hp, seed, device, model, crop_starts)
        pec.exact_bn_fed_gradients(self)


class SmallGradientReplay:
    """Adam's step g / (sqrt(v) + eps) turns the float32 rounding of a
    gradient entry near eps into a step of up to the learning rate, of
    either sign. In a dense layer that feeds a training-mode BatchNorm the
    gradient of an entry whose input hardly varies over the batch is such a
    cancellation. Measured in this test's run (AMD EPYC, 1 epoch, port
    against JAX): the crops of the validation pass were bit-equal and the
    port's forward on JAX's state gave JAX's logits within 6e-8, but 4 of
    the 10,304 kernel entries had a gradient below 100 eps at one of the 2
    steps (|g| 1.8e-7 to 9.3e-7), one of them moved 1.85e-3 apart (opposite
    Adam steps), and the running statistics taken through them followed:
    the validation logits were 1.8e-4 apart and ``val_loss`` 1.26e-4
    relative. With those entries and statistics taken from JAX the logits
    were 6.2e-6 apart. So the JAX trainer zeroes every gradient entry below
    100 eps at each step and records where (``optax``); the port's trainer
    zeroes the same entries at the same step (``wrap``). Both then compute
    the same step with no entry left to rounding."""

    def __init__(self):
        self.masks = []

    def optax(self):
        """``optax`` for the JAX trainer: JAX_OPTAX's chain with the
        small entries zeroed first."""
        def update(grads, state, params=None):
            small = jax.tree.map(lambda g: jnp.abs(g) < 100 * EPS, grads)
            jax.debug.callback(self.masks.append, small, ordered=True)
            return jax.tree.map(lambda g, m: jnp.where(m, 0.0, g), grads,
                                small), state

        zero = optax.GradientTransformation(lambda p: optax.EmptyState(),
                                            update)
        return types.SimpleNamespace(
            **{**vars(JAX_OPTAX),
               "chain": lambda *t: JAX_OPTAX.chain(zero, *t)})

    def wrap(self, trainer):
        """The port trainer's optimizer, zeroing at its n-th step the
        entries that JAX's n-th step zeroed."""
        names = [n for n, _ in trainer.model.named_parameters()]
        inner, step = trainer.tx, iter(range(1 << 30))

        def port_mask(mask):
            params = jax.tree.map(lambda m: np.asarray(m, np.float32), mask)
            stats = {k: {"mean": v["scale"], "var": v["scale"]}
                     for k, v in params.items() if k.startswith("bn_")}
            model = classifier_from_jax(
                {"params": params, "batch_stats": stats}, trainer.hp, "cpu")
            return dict(model.named_parameters())

        def update(grads, state, params, lr):
            mask = port_mask(self.masks[next(step)])
            grads = [torch.where(mask[n].detach() > 0.5, 0.0, g)
                     for n, g in zip(names, grads)]
            return inner.update(grads, state, params, lr)

        trainer.tx = Optimizer(inner.init, update)
        return trainer


def test_train_group_classifier_matches_jax(tmp_path, monkeypatch):
    paths = group_files(tmp_path)
    jhp, hp = tiny_hparams(use_labels="intended")
    replay = SmallGradientReplay()
    monkeypatch.setattr(jclf, "_dropout", _identity_dropout)
    monkeypatch.setattr(pclf, "dropout", _identity_dropout)
    monkeypatch.setattr(jec, "optax", replay.optax())
    monkeypatch.setattr(pstudy, "ClassifierTrainer",
                        lambda *a, **k: replay.wrap(JaxStartTrainer(*a, **k)))
    _, want = jstudy.train_group_classifier(paths, 2, hpc=jhp, epochs=3,
                                            seed=4)
    trainer, got = pstudy.train_group_classifier(
        paths, 2, hpc=hp, epochs=3, seed=4, device="cpu",
        crop_starts=JaxCropReplay(4, hp))
    assert hp.n_emotions == 2 and trainer.opt_state.count == 6
    assert len(replay.masks) == 6
    assert got.keys() == want.keys() >= {"history", "test_loss", "test_acc"}
    for g, w in zip(got["history"] + [got], want["history"] + [want]):
        for k in w:
            if k != "history":
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=0,
                                           err_msg=k)


def tiny_generator(seed=0):
    hp = HParams()
    hp.add_params(TINY_GENERATOR)
    return hp, Tacotron2(hp, device="cpu", seed=seed).eval()


def test_study_model_end_to_end(tmp_path):
    hp, model = tiny_generator()
    stages = {}
    metrics = pstudy.study_model(
        str(tmp_path), model, hp, text="hello world", n_groups=2, samples=3,
        predefined=False, force_emotions=False, force_noise=True,
        waveglow=None, classifier_epochs=2, seed=0, stage_seconds=stages)
    assert set(stages) == {"generate", "vocode", "featurize", "classify"}
    assert 0.0 <= metrics["generation_error_rate"] <= 1.0
    assert metrics["generation_error_rate"] == \
        metrics["max_decoder_steps_reached"] / 6
    assert set(metrics) == {"history", "test_loss", "test_acc",
                            "max_decoder_steps_reached",
                            "generation_error_rate"}
    assert len(metrics["history"]) == 2
    # 6 files leave no validation file: JAX's empty-split record.
    assert set(metrics["history"][0]) == {"epoch", "train_loss", "train_acc",
                                          "val_loss", "val_acc", "val_empty"}
    names = [f"{g}-{i}" for g in range(2) for i in range(3)]
    mel_dir = tmp_path / "GANtronInference"
    wav_dir = tmp_path / "WaveGlowInference"
    assert sorted(os.listdir(mel_dir)) == [f"{n}.npy" for n in names]
    assert sorted(os.listdir(wav_dir)) == sorted(
        f"{n}.{e}" for n in names for e in ("npy", "wav"))
    feat = np.load(wav_dir / "0-0.npy")
    assert feat.shape[0] == hp.n_mel_channels and feat.max() <= 0.0
    json.dumps(metrics)


def _write_vesus(root, tag, n, rng, emotions=("Neutral", "Angry")):
    """``n`` VESUS-layout tone wavs named ``tag<i>.wav`` and their
    'one'-label filelist lines."""
    lines = []
    for i in range(n):
        emotion = emotions[i % len(emotions)]
        rel = f"spk/{emotion}/{tag}{i}.wav"
        os.makedirs(os.path.join(root, "VESUS", "Audio", "spk", emotion),
                    exist_ok=True)
        write_wav(os.path.join(root, "VESUS", "Audio", rel),
                  synth_emotive_utterance("ames", emotion, 0, rng))
        votes = [0.0] * 5
        votes[("Neutral", "Angry", "Happy", "Sad", "Fearful")
              .index(emotion)] = 1.0
        lines.append(f"{rel}|ames|0|{','.join(map(str, votes))}")
    return lines


def test_classifier_and_inference_clis(tmp_path):
    rng = np.random.RandomState(0)
    audio = tmp_path / "audio"
    lists = {}
    for split, n in (("train", 8), ("val", 4), ("test", 4)):
        lists[split] = str(tmp_path / f"{split}.txt")
        with open(lists[split], "w") as f:
            f.write("\n".join(_write_vesus(str(audio), split, n, rng))
                    + "\n")
    hparams = ",".join(
        f"{k}=[{lists[s]},{lists[s]},{lists[s]}]"
        for k, s in (("training_files", "train"),
                     ("validation_files", "val"), ("test_files", "test")))
    out = classifier_cli.main([
        "--audio_path", str(audio), "--vesus_only", "true", "--epochs", "2",
        "--batch_size", "4", "--n_frames", "16", "--model_size", "32",
        "--mel_offset", "2", "--hparams", hparams + ",n_mel_channels=16",
        "-o", str(tmp_path / "out"), "--device", "cpu"])
    assert len(out["history"]) == 2 and "test_acc" in out
    with open(tmp_path / "out" / "classifier_history.json") as f:
        assert json.load(f) == out
    # The features the CLI cached beside the wavs, through a saved trainer.
    _, hp = tiny_hparams(use_labels="one")
    trainer = pec.ClassifierTrainer(hp, device="cpu")
    npys = sorted(str(p) for p in audio.rglob("train*.npy"))
    assert len(npys) == 8
    trainer.fit(pec.MelCrops(npys, [np.eye(5)[i % 2] for i in range(8)]),
                epochs=1)
    save = str(tmp_path / "clf.pt")
    trainer.save(save)
    wav = str(audio / "VESUS" / "Audio" / "spk" / "Angry" / "test1.wav")
    emotion = inference_cli.main(["-c", save, "--path", wav,
                                  "--device", "cpu"])
    assert emotion in ("Neutral", "Angry", "Happy", "Sad", "Fearful")
    savee = tmp_path / "savee"
    savee.mkdir()
    for name, emotion in (("a01.wav", "Angry"), ("n01.wav", "Neutral"),
                          ("x01.wav", "Neutral")):
        write_wav(str(savee / name),
                  synth_emotive_utterance("ames", emotion, 0, rng))
    acc = inference_cli.main(["-c", save, "--path", str(savee),
                              "--inference_folder", "--dataset", "SAVEE",
                              "--device", "cpu"])
    assert acc in (0.0, 50.0, 100.0)


def test_study_model_cli(tmp_path):
    hp, model = tiny_generator()
    ckpt = str(tmp_path / "g.ckpt")
    torch.save({"g_state": model.state_dict()}, ckpt)
    out = tmp_path / "study"
    hparams = ",".join(f"{k}={v}" for k, v in TINY_GENERATOR.items())
    study_cli.main(["-g", ckpt, "-o", str(out), "--samples", "2",
                    "--n_groups", "2", "--classifier_epochs", "1",
                    "--hparams", hparams, "--predefined", "false",
                    "--classifier_hparams", "n_frames=16,model_size=32",
                    "--device", "cpu"])
    with open(out / "study_metrics.json") as f:
        metrics = json.load(f)
    assert {"history", "generation_error_rate",
            "max_decoder_steps_reached"} <= set(metrics)
    assert len(os.listdir(out / "GANtronInference")) == 4
