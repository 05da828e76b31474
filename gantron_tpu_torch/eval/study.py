"""Vocoding a folder of sampled mels (port of ``compute_wavs`` of
gantron_tpu/eval/study.py; reference: study_model.py:33-95). The rest of the
controllability study (classifier, group labels) waits for the eval slice."""

import os

import numpy as np
import torch

from gantron_tpu_torch.audio.mel import MelSpectrogram, mel_to_wav_griffin_lim
from gantron_tpu_torch.data.wav import write_wav
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
