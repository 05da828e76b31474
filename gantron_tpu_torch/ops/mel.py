"""Fused log-mel featurizer: windowed FFT -> magnitude -> mel -> log-clamp
(port of gantron_tpu/ops/pallas_mel.py).

``log_mel(yp, consts)`` maps a reflect-padded waveform ``yp`` (B, S) to the
log-mel spectrogram (B, n_mel, T), T = (S - n_fft) // hop + 1:

  * on a CUDA tensor it launches the hand-written kernel ``csrc/mel.cu``
    (built with ``nvcc`` at first use) or raises;
  * on a CPU tensor it computes ``log_mel_plain``, the plain PyTorch version:
    frames @ windowed DFT basis, magnitude, @ mel weights, log-clamp. That is
    the JAX package's default route (``STFT.magnitude`` and the mel einsum,
    gantron_tpu/audio/mel.py:58-62).

There is no path from a CUDA tensor to the plain version. ``mel_spectrogram``
adds the reflect padding, and ``audio.mel.MelSpectrogram`` wraps it.
"""

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

CLIP = 1e-5  # the log's floor, as in dynamic_range_compression


class MelConstants(NamedTuple):
    """The kernel's constant operands, on one device.
    ``audio.mel.MelSpectrogram`` builds them: ``basis`` is its STFT's forward
    basis and ``mel_w`` holds its filterbank, so neither is held twice. The
    kernel's FFT route reads ``window``, ``twiddles`` and ``mel_bins``; its
    dense route (see ``mel_route``), the plain version and the STFT read
    ``basis``."""

    basis: torch.Tensor     # (n_fft, 2 * n_bins): [cos | -sin] x window
    mel_w: torch.Tensor     # (n_bins, n_mel): slaney filterbank, transposed
    hop: int
    window: torch.Tensor    # (n_fft,): the Hann window centred in n_fft
    twiddles: torch.Tensor  # (n_fft // 2, 2): e^(-2 pi i k / n_fft), re, im
    mel_bins: torch.Tensor  # (n_mel, 2) int32: [lo, hi) of nonzero bins


def fft_twiddles(n_fft: int) -> np.ndarray:
    """(n_fft // 2, 2) float32: e^(-2 pi i k / n_fft) for k < n_fft // 2,
    computed in float64 (the FFT's W_N^j for N = n_fft / 2 is row 2j)."""
    ang = -2.0 * np.pi * np.arange(n_fft // 2) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def mel_bin_ranges(mel_w: np.ndarray) -> np.ndarray:
    """(n_mel, 2) int32: for each column m of the (n_bins, n_mel)
    filterbank, [lo, hi) from its first to one past its last nonzero bin
    ([0, 0) for an empty filter)."""
    nz = mel_w != 0
    any_nz = nz.any(axis=0)
    lo = np.where(any_nz, nz.argmax(axis=0), 0)
    hi = np.where(any_nz, nz.shape[0] - nz[::-1].argmax(axis=0), 0)
    return np.stack([lo, hi], axis=1).astype(np.int32)


def reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by ``pad`` on both sides, as ``np.pad`` and
    ``jnp.pad`` with ``mode="reflect"`` do it, also where ``pad`` is not
    smaller than the signal (they reflect again, which
    ``torch.nn.functional.pad`` refuses): the padded signal is periodic
    with period 2 * (N - 1)."""
    N = y.shape[-1]
    idx = torch.arange(-pad, N + pad, device=y.device)
    if N == 1:
        idx = torch.zeros_like(idx)
    else:
        period = 2 * (N - 1)
        idx = idx.remainder(period)
        idx = torch.where(idx >= N, period - idx, idx)
    return y[..., idx]


def log_mel_plain(yp: torch.Tensor, consts: MelConstants) -> torch.Tensor:
    """Plain version of the kernel: (B, S) reflect-padded -> (B, n_mel, T)."""
    n_fft, n_bins = consts.basis.shape[0], consts.mel_w.shape[0]
    frames = yp.unfold(-1, n_fft, consts.hop)  # (B, T, n_fft), a view
    spec = frames @ consts.basis
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    mel = torch.sqrt(re * re + im * im) @ consts.mel_w
    return torch.log(torch.clamp(mel, min=CLIP)).transpose(1, 2).contiguous()


@functools.cache
def _lib():
    """The built kernel library with its C signatures declared (without
    argtypes ctypes would pass each pointer as a 32-bit int and cut it)."""
    from gantron_tpu_torch.utils.cuda_build import load_library

    lib = load_library("mel")
    lib.mel_launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                               + [ctypes.c_void_p])
    lib.mel_launch.restype = ctypes.c_int
    lib.mel_fft_route.argtypes = [ctypes.c_int]
    lib.mel_fft_route.restype = ctypes.c_int
    lib.mel_error_string.argtypes = [ctypes.c_int]
    lib.mel_error_string.restype = ctypes.c_char_p
    return lib


def mel_route(n_fft: int) -> str:
    """"fft" or "dense": the route the kernel takes for ``n_fft``, as the
    built library decides it (the FFT for a power of two from 64 to 4096).
    Builds the kernel at first use, so it needs ``nvcc``."""
    return "fft" if _lib().mel_fft_route(n_fft) else "dense"


def log_mel(yp: torch.Tensor, consts: MelConstants) -> torch.Tensor:
    """(B, S) reflect-padded waveform -> (B, n_mel, T) log-mel: the kernel
    for CUDA tensors, ``log_mel_plain`` for CPU tensors. ``log_mel.launches``
    counts kernel launches."""
    if yp.device.type == "cpu":
        return log_mel_plain(yp, consts)
    if yp.device.type != "cuda":
        raise ValueError(f"log_mel: unsupported device {yp.device}")
    basis, mel_w, hop, window, twiddles, mel_bins = consts
    floats = (yp, basis, mel_w, window, twiddles)
    if any(t.dtype != torch.float32 for t in floats) \
            or mel_bins.dtype != torch.int32:
        raise TypeError("log_mel: yp and the constants must be float32, "
                        "mel_bins int32")
    n_fft, n_bins, n_mel = basis.shape[0], mel_w.shape[0], mel_w.shape[1]
    if yp.dim() != 2 or basis.shape != (n_fft, 2 * n_bins) \
            or n_bins != n_fft // 2 + 1 or yp.shape[1] < n_fft \
            or window.shape != (n_fft,) \
            or twiddles.shape != (n_fft // 2, 2) \
            or mel_bins.shape != (n_mel, 2):
        raise ValueError(f"log_mel: shapes yp {tuple(yp.shape)}, basis "
                         f"{tuple(basis.shape)}, mel_w {tuple(mel_w.shape)}, "
                         f"window {tuple(window.shape)}, twiddles "
                         f"{tuple(twiddles.shape)}, mel_bins "
                         f"{tuple(mel_bins.shape)} do not form (B, S >= "
                         "n_fft), (n_fft, 2 * n_bins), (n_bins, n_mel), "
                         "(n_fft,), (n_fft // 2, 2), (n_mel, 2) with n_bins "
                         "= n_fft // 2 + 1")
    if any(t.device != yp.device for t in (*floats, mel_bins)):
        raise ValueError("log_mel: yp and the constants must be on one device")
    if not all(t.is_contiguous() for t in (*floats, mel_bins)):
        raise ValueError("log_mel: yp and the constants must be contiguous")
    B, S = yp.shape
    T = (S - n_fft) // hop + 1
    out = torch.empty((B, n_mel, T), dtype=torch.float32, device=yp.device)
    args = (yp.data_ptr(), basis.data_ptr(), mel_w.data_ptr(),
            window.data_ptr(), twiddles.data_ptr(), mel_bins.data_ptr(),
            out.data_ptr(), B, S, T, n_fft, hop, n_bins, n_mel,
            torch.cuda.current_stream(yp.device).cuda_stream)
    lib = _lib()
    if yp.device.index == torch.cuda.current_device():
        err = lib.mel_launch(*args)
    else:
        with torch.cuda.device(yp.device):
            err = lib.mel_launch(*args)
    if err != 0:
        raise RuntimeError("mel kernel launch failed: "
                           + lib.mel_error_string(err).decode())
    log_mel.launches += 1
    return out


log_mel.launches = 0


def mel_spectrogram(y: torch.Tensor, consts: MelConstants) -> torch.Tensor:
    """(B, N) waveform -> (B, n_mel, n_frames) log-mel: reflect padding by
    n_fft // 2, then ``log_mel`` (the counterpart of
    pallas_mel.pallas_mel_spectrogram)."""
    return log_mel(reflect_pad(y, consts.basis.shape[0] // 2), consts)
