"""Emotion-classifier training pipeline (port of
gantron_tpu/eval/classifier.py; reference: classifier.py:190-334).

  * ``prepare_npy_mels`` caches classifier-style dB mels next to the wavs
    (reference load_npy_mels/load_mel, classifier.py:190-226);
  * ``MelCrops`` applies the MelLoader transform: offset crop, additive
    uniform noise clipped to [-80, 0], ``/80 + 1`` normalization
    (reference data_utils.py:134-160). Its batches are the JAX package's,
    bit for bit, for the same seed;
  * ``ClassifierTrainer.fit`` runs L2 + Adam (``train.state.make_optimizer``
    with no clip, the JAX package's optax chain) with a cosine learning
    rate to 1e-6, the random-crop forward and argmax accuracy
    (classifier.py:137-177).

The trainer saves with ``torch.save``; it does not read the JAX package's
Orbax classifier directories.
"""

import dataclasses
import json
import os
import random
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from gantron_tpu_torch.audio.mel import PowerMelDB
from gantron_tpu_torch.data.filelists import load_cremad_ravdess, load_vesus
from gantron_tpu_torch.data.wav import load_wav
from gantron_tpu_torch.models.classifier import (BN_FED_BIAS, crop_batch,
                                                 make_classifier)
from gantron_tpu_torch.train.state import AdamState, Optimizer, make_optimizer
from gantron_tpu_torch.utils.device import generator, resolve_device


def prepare_npy_mels(filepaths_lists: Sequence[List[str]], hp,
                     file_format=".wav", device="cuda"):
    """Cache dB mels as .npy (features computed on ``device``); returns the
    new path lists."""
    mel_fn = PowerMelDB(hp.sampling_rate, hp.n_ftt, hp.hop_length,
                        hp.n_mel_channels, device=device)
    out_lists = []
    for filepaths in filepaths_lists:
        out = []
        for path in filepaths:
            new_path = path.split(file_format)[0] + ".npy"
            if not os.path.exists(new_path):
                wav = load_wav(path, hp.sampling_rate)
                np.save(new_path, mel_fn(wav[None])[0].cpu().numpy())
            out.append(new_path)
        out_lists.append(out)
    return out_lists


def load_files(files, audio_path, use_labels, vesus_only=False):
    """Merge VESUS (+ CREMA-D + RAVDESS) filelists
    (reference classifier.py:229-241)."""
    filepaths, _, emotions = load_vesus(files[0],
                                        audio_path + "/VESUS/Audio/",
                                        use_labels=use_labels, use_text=False)
    emotions = [list(e) for e in emotions]
    if not vesus_only:
        c_files, c_emo = load_cremad_ravdess(
            files[1], audio_path + "/Crema-D/AudioWAV/", use_labels, True)
        filepaths += c_files
        emotions += [list(e) for e in c_emo]
        r_files, r_emo = load_cremad_ravdess(
            files[2], audio_path + "/RAVDESS/Speech/", use_labels, False)
        filepaths += r_files
        emotions += [list(e) for e in r_emo]
    return filepaths, emotions


def load_extension(extend_path, use_labels, filepaths, emotions):
    """Extend training data with GANtron-generated wavs whose labels are
    encoded in the filename (reference classifier.py:244-251)."""
    to_label = ((lambda x: 1.0 if float(x) > 0 else 0.0)
                if use_labels in ("one", "intended") else float)
    for file in sorted(os.listdir(extend_path)):
        if ".wav" not in file or file[0] == "5":
            continue
        label = [to_label(v)
                 for v in file.split(".wav")[0].split("-")[-1].split(",")]
        filepaths.append(os.path.join(extend_path, file))
        emotions.append(label)


class MelCrops:
    """In-memory dataset of (dB mel, label) with the MelLoader transform.
    Noise and shuffles draw from a numpy ``RandomState(seed)``."""

    def __init__(self, mel_paths, emotions, mel_offset=0, max_noise=0,
                 seed=0):
        assert len(mel_paths) == len(emotions)
        self.mels = [np.load(p, allow_pickle=True).astype(np.float32)
                     for p in mel_paths]
        self.emotions = [np.asarray(e, np.float32) for e in emotions]
        self.mel_offset = mel_offset
        self.max_noise = max_noise
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.mels)

    def item(self, i):
        mel = self.mels[i][:, self.mel_offset:]
        if self.max_noise:
            mel = mel + self.rng.random_sample(mel.shape) * self.max_noise
            mel = np.clip(mel, -80.0, 0.0)
        return mel / 80.0 + 1.0, self.emotions[i]

    def batches(self, batch_size, shuffle=True, drop_last=True, pad_to=None):
        """(mels (B, n_mel, T), lengths (B,), labels (B, classes)) numpy
        batches, T the longest crop (at least ``pad_to``) rounded up to a
        multiple of 100. A dataset smaller than ``batch_size`` yields its
        one short batch."""
        order = list(range(len(self)))
        if shuffle:
            random.Random(self.rng.randint(1 << 30)).shuffle(order)
        for i in range(0, len(order), batch_size):
            idx = order[i:i + batch_size]
            if drop_last and len(idx) < batch_size and i > 0:
                break
            items = [self.item(j) for j in idx]
            T = max(m.shape[1] for m, _ in items)
            if pad_to:
                T = max(T, pad_to)
            T = ((T + 99) // 100) * 100
            B = len(items)
            M = items[0][0].shape[0]
            mels = np.zeros((B, M, T), np.float32)
            lengths = np.zeros((B,), np.int32)
            labels = np.zeros((B, len(items[0][1])), np.float32)
            for k, (m, e) in enumerate(items):
                mels[k, :, : m.shape[1]] = m
                lengths[k] = m.shape[1]
                labels[k] = e
            yield mels, lengths, labels


class ClassifierTrainer:
    """A ``Classifier`` of ``hp`` on ``device`` with its optimizer.

    Weights come from seed 0 unless ``model`` is given (the JAX trainer
    initialises from a fixed key too); ``seed`` seeds the crop draws (a CPU
    generator, so the card and the CPU crop alike) and the dropout draws (on
    ``device``). ``crop_starts(lengths, T, train)``, when given, returns
    each batch's (B,) crop starts in place of the draws: tests replay the
    JAX trainer's."""

    def __init__(self, hp, seed=0, device="cuda", model=None,
                 crop_starts: Optional[Callable] = None):
        self.hp = hp
        self.device = resolve_device(device)
        self.model = (model if model is not None
                      else make_classifier(hp, "cpu")).to(self.device)
        self.use_bce = hp.use_labels in ("one", "intended")
        self.crop_generator = torch.Generator().manual_seed(seed)
        self.dropout_generator = generator(self.device, seed)
        self.crop_starts = crop_starts
        self.tx = make_optimizer(0, hp.weight_decay)
        self.opt_state = self.tx.init(list(self.model.parameters()))

    def _loss(self, logits, labels):
        if self.use_bce:
            return torch.mean(torch.clamp(logits, min=0) - logits * labels
                              + torch.log1p(torch.exp(-logits.abs())))
        return torch.mean((torch.softmax(logits, -1) - labels) ** 2)

    @staticmethod
    def _accuracy(logits, labels):
        return (logits.argmax(-1) == labels.argmax(-1)).float().mean()

    def _crops(self, mels, lengths, train):
        hp = self.hp
        mels = torch.as_tensor(mels, device=self.device)
        starts = (self.crop_starts(lengths, mels.shape[2], train)
                  if self.crop_starts is not None else None)
        return crop_batch(mels, lengths, hp.n_frames, hp.mel_offset,
                          self.crop_generator, starts)

    def _train_step(self, mels, lengths, labels, lr):
        model = self.model.train()
        labels = torch.as_tensor(labels, device=self.device)
        crops = self._crops(mels, lengths, True)
        params = list(model.parameters())
        logits = model(crops, train=True, generator=self.dropout_generator)
        loss = self._loss(logits, labels)
        grads = torch.autograd.grad(loss, params)
        self.opt_state = self.tx.update(grads, self.opt_state, params, lr)
        return loss.detach(), self._accuracy(logits.detach(), labels)

    @torch.no_grad()
    def _eval_step(self, mels, lengths, labels):
        labels = torch.as_tensor(labels, device=self.device)
        logits = self.model.eval()(self._crops(mels, lengths, False),
                                   train=False)
        return self._loss(logits, labels), self._accuracy(logits, labels)

    def _lr(self, epoch):
        """Cosine annealing to 1e-6 over ``epochs`` (reference
        classifier.py:137-141)."""
        hp = self.hp
        return (1e-6 + 0.5 * (hp.lr - 1e-6)
                * (1 + np.cos(np.pi * epoch / hp.epochs)))

    @staticmethod
    def _means(losses, accs):
        """Per-batch float32 values averaged in float64, as the JAX trainer
        averages its ``float(loss)`` list."""
        return tuple(float(np.mean(torch.stack(v).cpu().numpy()
                                   .astype(np.float64)))
                     for v in (losses, accs))

    def fit(self, train_data: MelCrops, val_data: Optional[MelCrops] = None,
            epochs: Optional[int] = None, log_fn=None):
        hp = self.hp
        epochs = epochs or hp.epochs
        history = []
        for epoch in range(epochs):
            lr = float(np.float32(self._lr(epoch)))
            losses, accs = [], []
            for mels, lengths, labels in train_data.batches(
                    hp.batch_size, pad_to=hp.n_frames + hp.mel_offset):
                loss, acc = self._train_step(mels, lengths, labels, lr)
                losses.append(loss)
                accs.append(acc)
            if not losses:
                raise ValueError(
                    "training dataset produced zero batches "
                    f"(need >= batch_size={hp.batch_size} crops; "
                    "a mean over no batches would be NaN)")
            train_loss, train_acc = self._means(losses, accs)
            record = {"epoch": epoch, "train_loss": train_loss,
                      "train_acc": train_acc}
            if val_data is not None:
                record.update(self.evaluate(val_data))
            history.append(record)
            if log_fn:
                log_fn(record)
        return history

    def evaluate(self, data: MelCrops, prefix="val_"):
        """Mean loss and accuracy over ``data`` in eval mode, on random
        crops; the ``*_empty`` record for an empty split."""
        hp = self.hp
        losses, accs = [], []
        for mels, lengths, labels in data.batches(
                hp.batch_size, shuffle=False, drop_last=False,
                pad_to=hp.n_frames + hp.mel_offset):
            loss, acc = self._eval_step(mels, lengths, labels)
            losses.append(loss)
            accs.append(acc)
        if not losses:  # empty split (e.g. a tiny val fraction rounding to 0)
            return {prefix + "loss": float("nan"), prefix + "acc": 0.0,
                    prefix + "empty": True}
        loss, acc = self._means(losses, accs)
        return {prefix + "loss": loss, prefix + "acc": acc}

    def save(self, path):
        """``torch.save`` of the weights, the BatchNorm running statistics
        and the Adam state to ``path``, and the hparams (every field that is
        no list) to ``path + ".hparams.json"``, as the JAX trainer writes
        them."""
        path = os.path.abspath(path)
        st = self.opt_state
        torch.save({"model": {k: v.detach().cpu() for k, v in
                              self.model.state_dict().items()},
                    "opt_state": {"count": st.count,
                                  "mu": [m.cpu() for m in st.mu],
                                  "nu": [v.cpu() for v in st.nu]}}, path)
        hparams = {f.name: getattr(self.hp, f.name)
                   for f in dataclasses.fields(self.hp)
                   if not isinstance(getattr(self.hp, f.name), list)}
        with open(path + ".hparams.json", "w") as f:
            json.dump(hparams, f)

    @classmethod
    def load(cls, path, hp=None, device="cuda"):
        """A trainer on ``device`` from ``save``'s files; ``hp`` from the
        ``.hparams.json`` beside them unless given."""
        from gantron_tpu_torch.config import ClassifierHParams

        path = os.path.abspath(path)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if hp is None:
            hp = ClassifierHParams()
            meta_path = path + ".hparams.json"
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    for k, v in json.load(f).items():
                        hp.add_param(k, v)
        trainer = cls(hp, device=device)
        trainer.model.load_state_dict(payload["model"])
        st = payload["opt_state"]
        trainer.opt_state = AdamState(
            int(st["count"]), [m.to(trainer.device) for m in st["mu"]],
            [v.to(trainer.device) for v in st["nu"]])
        return trainer

    @torch.no_grad()
    def predict_probs(self, mels, lengths):
        """Eval-mode probabilities on one random crop of each mel."""
        crops = self._crops(mels, lengths, False)
        return self.model.eval().predict(crops).cpu().numpy()


def exact_bn_fed_gradients(trainer):
    """For parity runs (tests, chip_smoke.py): the trainer's optimizer gives
    the hidden layers' biases (``BN_FED_BIAS``) their exact gradient, 0,
    where each side of a comparison would step them by its own float32
    noise, and records each entry's smallest |gradient| over the steps in
    ``trainer.min_abs_grad`` (by parameter name), which says where Adam's
    step was conditioned. Returns the trainer."""
    named = list(trainer.model.named_parameters())
    fed = {i for i, (n, _) in enumerate(named) if BN_FED_BIAS.match(n)}
    trainer.min_abs_grad = {n: torch.full_like(p, float("inf"))
                            for n, p in named}
    inner = trainer.tx

    def update(grads, state, params, lr):
        grads = [torch.zeros_like(g) if i in fed else g
                 for i, g in enumerate(grads)]
        for (n, _), g in zip(named, grads):
            torch.minimum(trainer.min_abs_grad[n], g.abs(),
                          out=trainer.min_abs_grad[n])
        return inner.update(grads, state, params, lr)

    trainer.tx = Optimizer(inner.init, update)
    return trainer
