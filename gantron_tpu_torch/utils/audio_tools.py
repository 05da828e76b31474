"""Audio utilities (port of gantron_tpu/utils/audio_tools.py; reference
utils.py:34-44, 195-223)."""

import os
import random
from typing import Optional

import numpy as np
import torch

from gantron_tpu_torch.audio.mel import MelSpectrogram, mel_to_wav_griffin_lim
from gantron_tpu_torch.config import HParams
from gantron_tpu_torch.data.wav import load_wav, write_wav
from gantron_tpu_torch.utils.device import generator


def get_mel_from_audio(path, hp=None, device="cuda"):
    """Wav file -> synthesis-style log-mel (n_mel, T) numpy, featurized on
    ``device`` (the card unless ``device="cpu"`` is passed)."""
    hp = hp or HParams()
    mel_fn = MelSpectrogram(hp.filter_length, hp.hop_length, hp.win_length,
                            hp.n_mel_channels, hp.sampling_rate, hp.mel_fmin,
                            hp.mel_fmax, device=device)
    wav = load_wav(path, hp.sampling_rate)
    return mel_fn(wav[None])[0].cpu().numpy()


def mel_to_audio(base_path, waveglow_path: Optional[str] = None,
                 randomize=True, force_create=False, hp=None, device="cuda"):
    """Vocode every ``.npy`` mel in a folder to ``.wav`` on ``device``
    (reference utils.py:195-223). Uses WaveGlow when a checkpoint is given,
    Griffin-Lim otherwise (its initial phases seeded by the file's index).
    Returns the paths written."""
    hp = hp or HParams()
    waveglow = None
    if waveglow_path:
        from gantron_tpu_torch.models.waveglow import load_waveglow

        waveglow = load_waveglow(waveglow_path, device=device)
    mel_fn = MelSpectrogram(hp.filter_length, hp.hop_length, hp.win_length,
                            hp.n_mel_channels, hp.sampling_rate, hp.mel_fmin,
                            hp.mel_fmax, device=device)

    names = [p for p in os.listdir(base_path) if p.endswith(".npy")]
    if randomize:
        random.shuffle(names)
    written = []
    for i, name in enumerate(names):
        # Split on the extension, not the first dot: sampled mel names embed
        # rounded emotion floats ('0-3-0.6,0,....npy') whose dots are data.
        out_path = os.path.join(base_path, name[:-len(".npy")] + ".wav")
        if os.path.exists(out_path) and not force_create:
            continue
        mel = torch.from_numpy(np.load(os.path.join(base_path, name)))[None]
        if waveglow is not None:
            wav = waveglow.infer(mel, 0.666, generator(waveglow.device, i))
        else:
            wav = mel_to_wav_griffin_lim(mel, mel_fn,
                                         generator=generator(mel_fn.device, i))
        write_wav(out_path, wav[0].cpu().numpy(), hp.sampling_rate)
        written.append(out_path)
    return written
