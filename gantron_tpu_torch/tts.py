"""High-level text-to-speech API (port of gantron_tpu/tts.py).

    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.tts import Synthesizer
    synth = Synthesizer(HParams.create("use_noise=True,use_labels=False"))
    wav = synth.tts("Hello world.")            # Griffin-Lim
    wav = synth.tts("Hello world.", waveglow)  # neural vocoder

Runs on the card unless ``device="cpu"`` is passed. Without a ``model`` the
Tacotron2 weights are drawn from ``seed`` (no checkpoint loader is ported
yet).
"""

import numpy as np
import torch

from gantron_tpu_torch.audio.mel import MelSpectrogram, mel_to_wav_griffin_lim
from gantron_tpu_torch.models.tacotron2 import Tacotron2
from gantron_tpu_torch.text import text_to_sequence
from gantron_tpu_torch.utils.device import generator, resolve_device

# Independent random streams of one request, all derived from its seed.
_DROPOUT, _NOISE, _Z = range(3)


def _stream_seed(seed: int, stream: int) -> int:
    return 3 * int(seed) + stream


def _derive_text_lengths(ids: np.ndarray) -> np.ndarray:
    """Per-row valid lengths of a (B, T) id batch from trailing pad (id 0)
    runs. Symbol id 0 is the pad marker ``_`` and is never emitted by
    ``text_to_sequence`` for real text, so trailing zeros are padding. A row
    with no trailing zeros (or all zeros) gets the full length T."""
    rev_nonzero = (ids[:, ::-1] != 0)
    # argmax of all-False is 0 -> full length, the right degenerate answer.
    return (ids.shape[1] - rev_nonzero.argmax(axis=1)).astype(np.int64)


class Synthesizer:
    def __init__(self, hp, model: Tacotron2 = None, device="cuda",
                 seed: int = 0):
        self.device = resolve_device(device)
        self.hp = hp
        if model is None:
            model = Tacotron2(hp, device=self.device, seed=seed)
        self.model = model.to(self.device).eval()
        self.mel_fn = MelSpectrogram(
            hp.filter_length, hp.hop_length, hp.win_length,
            hp.n_mel_channels, hp.sampling_rate, hp.mel_fmin, hp.mel_fmax,
            device=self.device)

    def infer_mel(self, text, style=None, emotions=None, speaker=None,
                  seed=0, early_exit=True, text_lengths=None):
        """Text (str, 1-D ids, or (B, T) ids) -> (mel_postnet (n_mel, L),
        length L) as a tensor on the device. For a (B > 1, T) batch, returns a
        LIST of per-sample (mel, L) pairs.

        ``text_lengths``: optional (B,) true lengths of a PADDED id batch;
        derived from trailing pad (id 0) runs when None, so encoder state and
        attention never see pad positions."""
        if isinstance(text, str):
            ids = np.asarray(text_to_sequence(text, self.hp.text_cleaners),
                             np.int64)[None]
        else:
            ids = np.asarray(text, np.int64)
            if ids.ndim == 1:
                ids = ids[None]
        if text_lengths is None:
            text_lengths = _derive_text_lengths(ids)
        out = self.model.infer(
            torch.from_numpy(ids).to(self.device), style, emotions, speaker,
            None, early_exit,
            text_lengths=torch.as_tensor(np.asarray(text_lengths, np.int64)),
            generator=generator(self.device, _stream_seed(seed, _DROPOUT)),
            noise_generator=generator(self.device, _stream_seed(seed, _NOISE)))
        mels, lengths = out[1], out[4].tolist()
        if ids.shape[0] == 1:
            return mels[0, :, :lengths[0]], lengths[0]
        return [(mels[b, :, :L], L) for b, L in enumerate(lengths)]

    def tts(self, text, waveglow=None, style=None, emotions=None,
            speaker=None, seed=0, sigma=0.666,
            griffin_lim_iters=30) -> np.ndarray:
        """Text -> float32 waveform at ``hp.sampling_rate`` (one utterance;
        use infer_mel + a vocoder directly for batched synthesis). Without a
        WaveGlow it vocodes with ``griffin_lim_iters`` Griffin-Lim
        iterations, whose initial phases come from ``seed``."""
        result = self.infer_mel(text, style, emotions, speaker, seed)
        if isinstance(result, list):
            raise ValueError("tts() synthesizes one utterance; pass batched "
                             "ids to infer_mel() and vocode per sample")
        mel, _ = result
        if waveglow is not None:
            wav = waveglow.infer(
                mel[None], sigma,
                generator(waveglow.device, _stream_seed(seed, _Z)))
        else:
            wav = mel_to_wav_griffin_lim(
                mel[None], self.mel_fn, n_iters=griffin_lim_iters,
                generator=generator(self.device, _stream_seed(seed, _Z)))
        return wav[0].cpu().numpy()
