"""STFT as matrix products (port of gantron_tpu/audio/stft.py).

Reflect-pad, frame, and one ``(frames, n_fft) @ (n_fft, 2*cutoff)`` product
with the windowed Fourier basis, as the JAX package does it (there an einsum
at ``Precision.HIGHEST``; here ``torch.matmul`` in full float32, with TF32
left off). The inverse overlap-adds with ``torch.nn.functional.fold``, whose
sums run in a fixed order on the card (``index_add_`` would use atomics, whose
order changes from run to run).

The bases are built in numpy in float64, once a process for each
configuration, and kept on ``device``, which is the card unless
``device="cpu"`` is passed. The inverse basis (a pseudo-inverse, an SVD of
the 2*cutoff x n_fft Fourier matrix) is built at the first ``inverse``, so a
featurizer that never inverts never pays for it.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from gantron_tpu_torch.audio.filters import (hann_window, pad_center,
                                             window_sumsquare)
from gantron_tpu_torch.ops.mel import reflect_pad
from gantron_tpu_torch.utils.device import generator as make_generator
from gantron_tpu_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=8)
def _bases(filter_length, hop_length, win_length, window, inverse):
    """The forward basis (n_fft, 2*cutoff) or, with ``inverse``, the inverse
    basis (2*cutoff, n_fft), float32, window applied (read-only: shared)."""
    cutoff = filter_length // 2 + 1
    # Real/imag DFT basis, rows = frequency bins (like rfft).
    n = np.arange(filter_length)
    k = np.arange(cutoff)[:, None]
    omega = 2.0 * np.pi * k * n[None, :] / filter_length
    basis = np.vstack([np.cos(omega), -np.sin(omega)])  # (2*cutoff, n_fft)
    if inverse:
        scale = filter_length / hop_length
        basis = np.linalg.pinv(scale * basis).T  # (2*cutoff, n_fft)
    if window is not None:
        basis = basis * pad_center(hann_window(win_length, np.float64),
                                   filter_length)[None, :]
    # Transposed for right-multiplication: frames @ basis.
    out = np.ascontiguousarray(basis if inverse else basis.T, np.float32)
    out.flags.writeable = False
    return out


class STFT:
    """Forward/inverse STFT with reflect padding: magnitude and phase out,
    window-sumsquare-corrected inverse (reference stft.py:77-136)."""

    def __init__(self, filter_length=1024, hop_length=256, win_length=1024,
                 window="hann", device="cuda"):
        if win_length > filter_length:
            raise ValueError(f"win_length {win_length} exceeds filter_length "
                             f"{filter_length}")
        self.device = resolve_device(device)
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.window = window
        self.cutoff = filter_length // 2 + 1
        self.forward_basis = self._tensor(self._bases(inverse=False))
        self._inverse_basis = None
        self._norms = {}  # n_frames -> (mask, divisor) of the inverse

    def _bases(self, inverse):
        return _bases(self.filter_length, self.hop_length, self.win_length,
                      self.window, inverse)

    @property
    def inverse_basis(self) -> torch.Tensor:
        if self._inverse_basis is None:
            self._inverse_basis = self._tensor(self._bases(inverse=True))
        return self._inverse_basis

    def _tensor(self, a) -> torch.Tensor:
        # A copy on every device, so the cached arrays are never written.
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    def _as_input(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # -- framing ------------------------------------------------------------
    def n_frames(self, num_samples: int) -> int:
        return (num_samples + 2 * (self.filter_length // 2)
                - self.filter_length) // self.hop_length + 1

    def frame(self, y) -> torch.Tensor:
        """(B, T) -> (B, n_frames, filter_length) with reflect padding."""
        y = reflect_pad(self._as_input(y), self.filter_length // 2)
        return y.unfold(-1, self.filter_length, self.hop_length)

    # -- forward ------------------------------------------------------------
    def _spectrum(self, y):
        spec = self.frame(y) @ self.forward_basis
        return spec[..., :self.cutoff], spec[..., self.cutoff:]

    def transform(self, y):
        """(B, T) -> magnitude, phase of shape (B, cutoff, n_frames)."""
        real, imag = self._spectrum(y)
        magnitude = torch.sqrt(real ** 2 + imag ** 2)
        phase = torch.atan2(imag, real)
        return magnitude.transpose(1, 2), phase.transpose(1, 2)

    def magnitude(self, y) -> torch.Tensor:
        """Magnitude only: (B, T) -> (B, cutoff, n_frames)."""
        real, imag = self._spectrum(y)
        return torch.sqrt(real ** 2 + imag ** 2).transpose(1, 2)

    # -- inverse ------------------------------------------------------------
    def _norm(self, n_frames):
        """Where the window's sum-square envelope is above float32's tiny,
        and the divisor there (1 elsewhere), on the device."""
        if n_frames not in self._norms:
            wss = window_sumsquare(self.win_length, n_frames, self.hop_length,
                                   self.filter_length)
            tiny = np.finfo(np.float32).tiny
            self._norms[n_frames] = (
                torch.from_numpy(wss > tiny).to(self.device),
                self._tensor(np.where(wss > tiny, wss, 1.0)))
        return self._norms[n_frames]

    def inverse(self, magnitude, phase) -> torch.Tensor:
        """(B, cutoff, T') x2 -> (B, 1, T) reconstructed signal."""
        magnitude, phase = self._as_input(magnitude), self._as_input(phase)
        n_frames = magnitude.shape[-1]
        coeffs = torch.cat([magnitude * torch.cos(phase),
                            magnitude * torch.sin(phase)], dim=1)
        # (B, 2*cutoff, T') -> per-frame time snippets (B, n_fft, T')
        frames_rec = (coeffs.transpose(1, 2) @ self.inverse_basis) \
            .transpose(1, 2)

        # Overlap-add.
        total = self.filter_length + self.hop_length * (n_frames - 1)
        sig = F.fold(frames_rec, output_size=(1, total),
                     kernel_size=(1, self.filter_length),
                     stride=(1, self.hop_length))[:, 0, 0]

        # Window sum-square correction (remove modulation effects).
        keep, divisor = self._norm(n_frames)
        sig = torch.where(keep[None, :], sig / divisor[None, :], sig)
        sig = sig * (float(self.filter_length) / self.hop_length)

        pad = self.filter_length // 2
        return sig[:, pad:-pad][:, None, :]


def griffin_lim(magnitudes, stft_fn: STFT, n_iters: int = 30, angles=None,
                generator: torch.Generator = None) -> torch.Tensor:
    """Phase recovery by iterative STFT projection (reference:
    audio_processing.py:59-75). ``magnitudes``: (B, cutoff, T').

    The initial phases are ``angles`` when given (tests pass the JAX
    package's draw), else uniform in [-pi, pi) from ``generator`` (seed 0 on
    the STFT's device when None, as the JAX package's key 0)."""
    magnitudes = stft_fn._as_input(magnitudes)
    if angles is None:
        if generator is None:
            generator = make_generator(stft_fn.device, 0)
        angles = torch.rand(magnitudes.shape, generator=generator,
                            device=stft_fn.device) * (2 * np.pi) - np.pi
    signal = stft_fn.inverse(magnitudes, angles)[:, 0]
    for _ in range(n_iters):
        _, angles = stft_fn.transform(signal)
        signal = stft_fn.inverse(magnitudes, angles)[:, 0]
    return signal
