"""Fused log-mel featurizer: windowed DFT -> magnitude -> mel -> log-clamp
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

import torch

CLIP = 1e-5  # the log's floor, as in dynamic_range_compression


class MelConstants(NamedTuple):
    """The kernel's constant operands, float32 on one device.
    ``audio.mel.MelSpectrogram`` builds them: ``basis`` is its STFT's forward
    basis and ``mel_w`` holds its filterbank, so neither is held twice."""

    basis: torch.Tensor  # (n_fft, 2 * n_bins): [cos | -sin] x Hann window
    mel_w: torch.Tensor  # (n_bins, n_mel): slaney filterbank, transposed
    hop: int


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
    lib.mel_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                               + [ctypes.c_void_p])
    lib.mel_launch.restype = ctypes.c_int
    lib.mel_error_string.argtypes = [ctypes.c_int]
    lib.mel_error_string.restype = ctypes.c_char_p
    return lib


def log_mel(yp: torch.Tensor, consts: MelConstants) -> torch.Tensor:
    """(B, S) reflect-padded waveform -> (B, n_mel, T) log-mel: the kernel
    for CUDA tensors, ``log_mel_plain`` for CPU tensors. ``log_mel.launches``
    counts kernel launches."""
    if yp.device.type == "cpu":
        return log_mel_plain(yp, consts)
    if yp.device.type != "cuda":
        raise ValueError(f"log_mel: unsupported device {yp.device}")
    basis, mel_w, hop = consts
    if yp.dtype != torch.float32 or basis.dtype != torch.float32 \
            or mel_w.dtype != torch.float32:
        raise TypeError("log_mel: yp, basis and mel_w must be float32")
    n_fft, n_bins, n_mel = basis.shape[0], mel_w.shape[0], mel_w.shape[1]
    if yp.dim() != 2 or basis.shape != (n_fft, 2 * n_bins) \
            or yp.shape[1] < n_fft:
        raise ValueError(f"log_mel: shapes yp {tuple(yp.shape)}, basis "
                         f"{tuple(basis.shape)}, mel_w {tuple(mel_w.shape)} "
                         "do not form (B, S >= n_fft), (n_fft, 2 * n_bins), "
                         "(n_bins, n_mel)")
    if basis.device != yp.device or mel_w.device != yp.device:
        raise ValueError("log_mel: yp and the constants must be on one device")
    if not (yp.is_contiguous() and basis.is_contiguous()
            and mel_w.is_contiguous()):
        raise ValueError("log_mel: yp, basis and mel_w must be contiguous")
    B, S = yp.shape
    T = (S - n_fft) // hop + 1
    out = torch.empty((B, n_mel, T), dtype=torch.float32, device=yp.device)
    args = (yp.data_ptr(), basis.data_ptr(), mel_w.data_ptr(), out.data_ptr(),
            B, S, T, n_fft, hop, n_bins, n_mel,
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
