"""End-to-end controllability study (port of gantron_tpu/eval/study.py;
reference: study_model.py).

Pipeline:
  1. generate mels with forced style/emotion groups (eval.sampling);
  2. vocode to wav (WaveGlow if one is given, else Griffin-Lim);
  3. re-extract classifier-style dB mels from the wavs;
  4. train a fresh classifier to predict the *group id*;
  5. report group-classification accuracy (controllability proxy) and the
     generation error rate (decoder-cap hits / samples)
     (reference study_model.py:142-197).
"""

import os
import time
from typing import Optional

import numpy as np
import torch

from gantron_tpu_torch.audio.mel import (MelSpectrogram, PowerMelDB,
                                         mel_to_wav_griffin_lim)
from gantron_tpu_torch.config import ClassifierHParams
from gantron_tpu_torch.data.wav import load_wav, write_wav
from gantron_tpu_torch.eval.classifier import ClassifierTrainer, MelCrops
from gantron_tpu_torch.eval.sampling import force_style_emotions
from gantron_tpu_torch.text import text_to_sequence
from gantron_tpu_torch.utils.device import generator as make_generator
from gantron_tpu_torch.utils.device import resolve_device


def compute_wavs(mel_dir, wav_dir, hp, waveglow=None, batch_size=8,
                 generator=None, device="cuda"):
    """Vocode every .npy mel in ``mel_dir`` to a .wav in ``wav_dir``, in
    zero-padded batches of ``batch_size``: with ``waveglow`` when given,
    else 30 Griffin-Lim iterations on ``device`` whose initial phases come
    from ``generator`` (seed 0 on ``device`` when None). A wav that exists
    already is kept. Returns the wav paths in the mels' sorted order."""
    device = resolve_device(device)
    os.makedirs(wav_dir, exist_ok=True)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    mel_fn = MelSpectrogram(hp.filter_length, hp.hop_length, hp.win_length,
                            hp.n_mel_channels, hp.sampling_rate, hp.mel_fmin,
                            hp.mel_fmax, device=device)
    paths = sorted(p for p in os.listdir(mel_dir) if p.endswith(".npy"))
    # Partition up front: a cache hit on the LAST path must not skip the
    # final flush of pending mels.
    new_paths = {}
    todo = []
    for p in paths:
        out_path = os.path.join(wav_dir, p.split(".npy")[0] + ".wav")
        if os.path.exists(out_path):
            new_paths[p] = out_path
        else:
            todo.append((p, out_path))

    for start in range(0, len(todo), batch_size):
        chunk = todo[start:start + batch_size]
        mels = [np.load(os.path.join(mel_dir, p)) for p, _ in chunk]
        # Degenerate decodes (a gate firing on frame 1 from an untrained
        # model) can be near-empty; the ISTFT reflect-pad needs at least a
        # window of audio, so pad the batch to a safe minimum.
        min_frames = hp.filter_length // hp.hop_length + 1
        max_len = max(max(m.shape[1] for m in mels), min_frames)
        padded = np.zeros((len(mels), hp.n_mel_channels, max_len), np.float32)
        for j, m in enumerate(mels):
            padded[j, :, : m.shape[1]] = m
        if waveglow is not None:
            wavs = waveglow.infer(torch.from_numpy(padded), 0.666, generator)
        else:
            wavs = mel_to_wav_griffin_lim(torch.from_numpy(padded), mel_fn,
                                          n_iters=30, generator=generator)
        wavs = wavs.cpu().numpy()
        for j, ((p, out), m) in enumerate(zip(chunk, mels)):
            n_samples = m.shape[1] * hp.hop_length
            write_wav(out, wavs[j][:n_samples], hp.sampling_rate)
            new_paths[p] = out
    # Original listing order (callers pair these with group labels).
    return [new_paths[p] for p in paths]


def group_labels_from_paths(file_paths, n_groups):
    """File name prefix 'g-i' -> one-hot group label
    (reference study_model.py:121-139)."""
    labels = np.zeros((len(file_paths), n_groups), np.float32)
    for i, fp in enumerate(file_paths):
        group = int(os.path.basename(fp).split("-")[0])
        labels[i, group] = 1
    return labels


def split_train_val_test(paths, labels, seed=0):
    """85% / 5% / 10% of a ``RandomState(seed)`` shuffle."""
    idx = list(range(len(paths)))
    np.random.RandomState(seed).shuffle(idx)
    val_lim = int(0.85 * len(paths))
    test_lim = val_lim + int(0.05 * len(paths))

    def pick(ids):
        return [paths[i] for i in ids], labels[ids]

    return (pick(idx[:val_lim]), pick(idx[val_lim:test_lim]),
            pick(idx[test_lim:]))


def train_group_classifier(files_paths, n_groups,
                           hpc: Optional[ClassifierHParams] = None,
                           epochs=None, log_fn=None, seed=0, device="cuda",
                           crop_starts=None):
    """Train a fresh classifier on group ids on ``device``; returns
    (trainer, metrics). ``crop_starts`` goes to ``ClassifierTrainer``."""
    hpc = hpc or ClassifierHParams()
    hpc.n_emotions = n_groups
    labels = group_labels_from_paths(files_paths, n_groups)
    (tr_p, tr_l), (va_p, va_l), (te_p, te_l) = split_train_val_test(
        files_paths, labels, seed)

    def make(p, lab, s):
        return MelCrops(p, list(lab), hpc.mel_offset, hpc.max_noise, seed=s)

    trainer = ClassifierTrainer(hpc, seed=seed, device=device,
                                crop_starts=crop_starts)
    history = trainer.fit(make(tr_p, tr_l, 1), make(va_p, va_l, 2),
                          epochs=epochs or hpc.epochs, log_fn=log_fn)
    test_metrics = (trainer.evaluate(make(te_p, te_l, 3), prefix="test_")
                    if te_p else {})
    return trainer, {"history": history, **test_metrics}


def study_model(output_path, model, hp, text, n_groups=6, samples=10,
                predefined=True, force_emotions=None, force_noise=None,
                int_labels=False, waveglow=None, classifier_epochs=20, seed=0,
                log_fn=None, speaker=0, waveglow_bs=8,
                classifier_hp: Optional[ClassifierHParams] = None,
                stage_seconds: Optional[dict] = None):
    """Full study pipeline on the device of the port ``Tacotron2`` ``model``;
    returns a metrics dict including ``generation_error_rate`` and
    group-classification accuracy. ``stage_seconds``, when given, receives
    the wall seconds of each stage (generate, vocode, featurize,
    classify)."""
    device = model.device
    mel_dir = os.path.join(output_path, "GANtronInference")
    wav_dir = os.path.join(output_path, "WaveGlowInference")
    os.makedirs(mel_dir, exist_ok=True)
    clock = {"t": time.perf_counter()}

    def stage(name):
        now = time.perf_counter()
        if stage_seconds is not None:
            stage_seconds[name] = now - clock["t"]
        clock["t"] = now

    sequence = np.asarray(text_to_sequence(text, ["english_cleaners"]),
                          np.int64)[None]
    force_emotions = (model.use_labels if force_emotions is None
                      else force_emotions)
    force_noise = (hp.use_noise if force_noise is None else force_noise)

    reached = force_style_emotions(
        model, sequence, mel_dir, speaker=speaker,
        force_emotions=force_emotions, force_style=force_noise,
        style_shape=[sequence.shape[1], hp.noise_size], n_groups=n_groups,
        n_samples_styles=samples, simple_name=True, int_emotions=int_labels,
        predefined=predefined, max_decoder_steps=hp.max_decoder_steps,
        generator=make_generator(device, seed))
    stage("generate")

    wav_paths = compute_wavs(mel_dir, wav_dir, hp, waveglow=waveglow,
                             batch_size=waveglow_bs, device=device)
    stage("vocode")

    # Classifier-style features from the vocoded wavs.
    feat_fn = PowerMelDB(hp.sampling_rate, hp.filter_length, hp.hop_length,
                         hp.n_mel_channels, device=device)
    npy_paths = []
    for wp in wav_paths:
        npy = wp.replace(".wav", ".npy")
        if not os.path.exists(npy):
            wav = load_wav(wp, hp.sampling_rate)
            np.save(npy, feat_fn(wav[None])[0].cpu().numpy())
        npy_paths.append(npy)
    stage("featurize")

    _, metrics = train_group_classifier(npy_paths, n_groups,
                                        hpc=classifier_hp,
                                        epochs=classifier_epochs,
                                        log_fn=log_fn, seed=seed,
                                        device=device)
    stage("classify")
    n_files = max(len(npy_paths), 1)
    metrics["max_decoder_steps_reached"] = reached
    metrics["generation_error_rate"] = reached / n_files
    return metrics
