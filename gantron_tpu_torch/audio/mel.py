"""Mel-spectrogram featurizer and Griffin-Lim vocoding (port of
gantron_tpu/audio/mel.py; reference layers.py:76-114).

wav (B, T) in [-1, 1] -> STFT magnitude -> mel filterbank product ->
log-clamp. ``MelSpectrogram`` computes the whole chain with one call of
``ops.mel.log_mel``: the hand-written kernel ``csrc/mel.cu`` on the card, its
plain PyTorch version on the CPU.
"""

import numpy as np
import torch
import torch.nn.functional as F

from gantron_tpu_torch.audio.filters import mel_filterbank
from gantron_tpu_torch.audio.stft import STFT, griffin_lim
from gantron_tpu_torch.ops.mel import CLIP, MelConstants, mel_spectrogram
from gantron_tpu_torch.utils.device import resolve_device


def dynamic_range_compression(x, C=1, clip_val=CLIP):
    return torch.log(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x, C=1):
    return torch.exp(x) / C


class MelSpectrogram:
    """TacotronSTFT equivalent: holds the STFT and mel basis constants on
    ``device`` (the card unless ``device="cpu"`` is passed)."""

    def __init__(self, filter_length=1024, hop_length=256, win_length=1024,
                 n_mel_channels=80, sampling_rate=22050, mel_fmin=0.0,
                 mel_fmax=8000.0, backend="xla", device="cuda"):
        """``backend`` ('xla' or 'pallas') is kept for the JAX package's
        signature and selects nothing: both compute ``ops.mel.log_mel``,
        whose route on the card is the kernel and on the CPU the plain
        version (the JAX 'xla' einsum pipeline)."""
        if backend not in ("xla", "pallas"):
            raise ValueError(f"unknown mel backend {backend!r}")
        self.device = resolve_device(device)
        self.n_mel_channels = n_mel_channels
        self.sampling_rate = sampling_rate
        self.backend = backend
        self.stft = STFT(filter_length, hop_length, win_length,
                         device=self.device)
        # The kernel reads the filterbank as (cutoff, n_mels), contiguous;
        # mel_basis is the (n_mels, cutoff) view of the same tensor.
        mel_w = torch.from_numpy(np.ascontiguousarray(mel_filterbank(
            sampling_rate, filter_length, n_mel_channels, mel_fmin,
            mel_fmax).T)).to(self.device)
        self.mel_basis = mel_w.T
        self.consts = MelConstants(self.stft.forward_basis, mel_w,
                                   int(hop_length))

    def spectral_normalize(self, magnitudes):
        return dynamic_range_compression(magnitudes)

    def spectral_de_normalize(self, magnitudes):
        return dynamic_range_decompression(magnitudes)

    def __call__(self, y):
        return self.mel_spectrogram(y)

    def mel_spectrogram(self, y) -> torch.Tensor:
        """(B, T) float in [-1, 1] -> (B, n_mel_channels, n_frames)."""
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        return mel_spectrogram(y, self.consts)

    def n_frames(self, num_samples: int) -> int:
        return self.stft.n_frames(num_samples)


def mel_to_wav_griffin_lim(mel, mel_fn: MelSpectrogram, n_iters=30,
                           angles=None, generator=None) -> torch.Tensor:
    """Vocoder-free synthesis: invert the log-mel through the filterbank's
    pseudo-inverse, then Griffin-Lim phase recovery (the reference ships
    griffin_lim as the WaveGlow-free fallback, audio_processing.py:59-75).

    mel: (B, n_mel, T) log-compressed mel. Returns (B, T_samples) float32 on
    the mel_fn's device: (T - 1) * hop samples, or T * hop for a mel shorter
    than n_fft / hop + 1 frames. ``angles`` and ``generator`` go to
    ``griffin_lim``; ``angles`` has the shape of the padded magnitudes."""
    mel = torch.as_tensor(mel, dtype=torch.float32, device=mel_fn.device)
    # Degenerate inputs (an untrained gate firing on frame 1 gives a 1-frame
    # mel) crash the ISTFT's reflect pad; right-pad to a safe minimum and
    # trim the waveform back afterwards.
    T = mel.shape[2]
    min_frames = mel_fn.stft.filter_length // mel_fn.stft.hop_length + 1
    if T < min_frames:
        mel = F.pad(mel, (0, min_frames - T),
                    value=-11.5129)  # log(1e-5): silence floor

    mag_mel = dynamic_range_decompression(mel)
    # The pseudo-inverse in numpy from the float32 basis, as the JAX package
    # computes it, so both invert with the same matrix.
    pinv = torch.from_numpy(np.linalg.pinv(mel_fn.mel_basis.cpu().numpy())) \
        .to(mel_fn.device)
    magnitudes = torch.clamp(pinv @ mag_mel, min=0.0)
    wav = griffin_lim(magnitudes, mel_fn.stft, n_iters=n_iters, angles=angles,
                      generator=generator)
    return wav[:, :T * mel_fn.stft.hop_length]


def power_to_db(S, amin=1e-10, top_db=80.0, ref_axis=None):
    """librosa ``power_to_db(..., ref=np.max)``: 10*log10(S/max), floored at
    max - top_db. Used by the classifier featurizer (reference
    classifier.py:220-226).

    ``ref_axis``: axes the max reference is taken over. librosa operates on
    one spectrogram at a time, so a batched caller must pass per-sample axes
    (e.g. ``(-2, -1)``): a single global max would shift every sample's dB
    scale by the loudest utterance in the batch."""
    ref = S.max() if ref_axis is None else torch.amax(S, dim=ref_axis,
                                                      keepdim=True)
    ref = torch.clamp(ref, min=amin)
    log_spec = 10.0 * (torch.log10(torch.clamp(S, min=amin))
                       - torch.log10(ref))
    return torch.clamp(log_spec, min=-top_db)


class PowerMelDB:
    """Classifier-style mel features: power spectrogram -> slaney mel ->
    dB re max, range [-80, 0] (librosa.feature.melspectrogram +
    power_to_db as in reference classifier.py:220-226; fmax defaults to
    sr/2 there, unlike the synthesis mel's 8 kHz)."""

    def __init__(self, sampling_rate=22050, n_fft=1024, hop_length=256,
                 n_mel_channels=80, device="cuda"):
        self.device = resolve_device(device)
        self.stft = STFT(n_fft, hop_length, n_fft, device=self.device)
        self.mel_basis = torch.from_numpy(mel_filterbank(
            sampling_rate, n_fft, n_mel_channels, 0.0,
            sampling_rate / 2)).to(self.device)

    def __call__(self, y) -> torch.Tensor:
        """(B, T) -> (B, n_mel, n_frames) in [-80, 0] dB."""
        power = self.stft.magnitude(y) ** 2
        return power_to_db(self.mel_basis @ power, ref_axis=(-2, -1))
