"""The mel kernel's FFT route, held on the CPU through its host-built
constants and a numpy model of its arithmetic.

``csrc/mel.cu`` runs only on the card, where chip_smoke.py holds it against
``log_mel_plain``. Here the constants that ``MelSpectrogram`` builds for it
(window, twiddle table, mel bin ranges) are held against the JAX package's
filters and the existing basis and filterbank, and ``_kernel_model`` repeats
the kernel's passes in numpy with the same index arithmetic: the packed
half-length FFT as in-place radix-2 / radix-2^2 decimation-in-frequency
passes with bit-reversed output, then the split step. Tolerances: the window
is bit-equal; the twiddle table agrees with e^(-2 pi i k / n_fft) to 1e-7
(float32 rounding of values in [-1, 1]); the complex64 model agrees with the
float32 ``frames @ basis`` to 1e-4 (both float32 sums, in another order);
the float64 model agrees with ``np.fft.rfft`` to 1e-9; a mel sum over
[lo_m, hi_m) equals the sum over all bins bit for bit (the bins outside add
exact zeros).
"""

import numpy as np
import pytest
import torch

from gantron_tpu.audio import filters as jf
from gantron_tpu_torch.audio import mel as pmel
from gantron_tpu_torch.ops import mel as pops
from torch_threads import one_torch_thread  # noqa: F401


def _frames(n_fft, hop, n_frames, seed):
    rng = np.random.RandomState(seed)
    y = np.clip(rng.randn(1, (n_frames - 1) * hop + n_fft) * 0.2, -1, 1)
    y = torch.from_numpy(y.astype(np.float32))
    return y.unfold(-1, n_fft, hop)[0].numpy()  # (n_frames, n_fft)


def _kernel_model(frames, window, twiddles, dtype):
    """The kernel's FFT route up to the magnitudes, in numpy: (F, n_fft)
    frames -> (F, n_fft // 2 + 1) complex spectrum X."""
    cdt = np.complex64 if dtype == np.float32 else np.complex128
    n_fft = frames.shape[1]
    N = n_fft // 2
    lg = N.bit_length() - 1
    x = (frames * window[None, :]).astype(dtype)
    buf = (x[:, 0::2] + 1j * x[:, 1::2]).astype(cdt)
    W = (twiddles[:, 0] + 1j * twiddles[:, 1]).astype(cdt)

    def radix2():  # span N, W_N^p = table[2p]
        p = np.arange(N // 2)
        a, b = buf[:, p], buf[:, p + N // 2]
        buf[:, p], buf[:, p + N // 2] = a + b, (a - b) * W[2 * p]

    def radix4(lq):  # spans 4q and 2q fused
        q = 1 << lq
        jj = np.arange(N // 4)
        r = jj & (q - 1)
        n0 = ((jj >> lq) << (lq + 2)) + r
        w1, w2 = W[r << (lg - 1 - lq)], W[r << (lg - lq)]
        a0, a1, a2, a3 = (buf[:, n0 + k * q] for k in range(4))
        b0, b2 = a0 + a2, (a0 - a2) * w1
        b1, b3 = a1 + a3, (a1 - a3) * w1 * cdt(-1j)
        buf[:, n0], buf[:, n0 + q] = b0 + b1, (b0 - b1) * w2
        buf[:, n0 + 2 * q], buf[:, n0 + 3 * q] = b2 + b3, (b2 - b3) * w2

    if lg & 1:
        radix2()
        lq = lg - 3
    else:
        radix4(lg - 2)
        lq = lg - 4
    for lq in range(lq, -1, -2):
        radix4(lq)

    # Split step, reading Z at bit-reversed positions.
    k = np.arange(N + 1)
    rev = np.array([int(format(i, f"0{lg}b")[::-1], 2) for i in range(N)])
    zk, zn = buf[:, rev[k % N]], buf[:, rev[(N - k) % N]]
    w = np.where(k < N, W[k % N], cdt(-1))
    s, d = zk + np.conj(zn), zk - np.conj(zn)
    return (0.5 * (s - 1j * w * d)).astype(cdt)


@pytest.mark.parametrize("n_fft,win", [(1024, 1024), (1024, 800),
                                       (512, 512), (256, 200)])
def test_window_is_the_centred_hann_window(n_fft, win):
    consts = pmel.MelSpectrogram(filter_length=n_fft, hop_length=n_fft // 4,
                                 win_length=win, device="cpu").consts
    expected = jf.pad_center(jf.hann_window(win, np.float64), n_fft)
    np.testing.assert_array_equal(consts.window.numpy(),
                                  expected.astype(np.float32))
    # The window is the one folded into the basis (its cos column, k = 0).
    np.testing.assert_allclose(consts.basis[:, 0].numpy(), expected,
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_fft", [64, 512, 1024, 4096])
def test_twiddle_table(n_fft):
    tw = pops.fft_twiddles(n_fft)
    assert tw.shape == (n_fft // 2, 2) and tw.dtype == np.float32
    exact = np.exp(-2j * np.pi * np.arange(n_fft // 2) / n_fft)
    np.testing.assert_allclose(tw[:, 0] + 1j * tw[:, 1], exact, rtol=0,
                               atol=1e-7)
    consts = pmel.MelSpectrogram(filter_length=n_fft, hop_length=n_fft // 4,
                                 win_length=n_fft, device="cpu").consts
    np.testing.assert_array_equal(consts.twiddles.numpy(), tw)


@pytest.mark.parametrize("n_fft", [256, 512, 1024])
def test_kernel_model_matches_the_dense_basis(n_fft):
    consts = pmel.MelSpectrogram(filter_length=n_fft, hop_length=n_fft // 4,
                                 win_length=n_fft * 3 // 4,
                                 device="cpu").consts
    frames = _frames(n_fft, n_fft // 4, 9, n_fft)
    X = _kernel_model(frames, consts.window.numpy(),
                      consts.twiddles.numpy(), np.float32)
    spec = frames @ consts.basis.numpy()
    nb = n_fft // 2 + 1
    np.testing.assert_allclose(X.real, spec[:, :nb], atol=1e-4)
    np.testing.assert_allclose(X.imag, spec[:, nb:], atol=1e-4)
    np.testing.assert_allclose(np.abs(X), np.hypot(spec[:, :nb], spec[:, nb:]),
                               atol=1e-4)


@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024, 2048, 4096])
def test_kernel_model_is_the_real_fft(n_fft):
    """Every power of two of the FFT route, both parities of log2(n_fft / 2):
    the passes' index arithmetic in float64 against numpy's FFT."""
    frames = _frames(n_fft, n_fft // 2, 3, 7).astype(np.float64)
    window = jf.pad_center(jf.hann_window(n_fft, np.float64), n_fft)
    ang = -2.0 * np.pi * np.arange(n_fft // 2) / n_fft
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    X = _kernel_model(frames, window, tw, np.float64)
    np.testing.assert_allclose(X, np.fft.rfft(frames * window, axis=1),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("cfg", [(22050, 1024, 80, 0.0, 8000.0),
                                 (22050, 1024, 80, 0.0, None),
                                 (16000, 512, 40, 50.0, 7000.0)])
def test_mel_bin_ranges_cover_every_nonzero(cfg):
    sr, n_fft, n_mels, fmin, fmax = cfg
    mel_w = np.ascontiguousarray(
        jf.mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T).astype(np.float64)
    bins = pops.mel_bin_ranges(mel_w)
    assert bins.shape == (n_mels, 2) and bins.dtype == np.int32
    for m, (lo, hi) in enumerate(bins):
        nz = np.flatnonzero(mel_w[:, m])
        assert (lo, hi) == ((nz[0], nz[-1] + 1) if len(nz) else (0, 0))
    mag = np.abs(np.random.RandomState(n_fft).randn(6, n_fft // 2 + 1))
    dense = np.zeros((6, n_mels))
    for k in range(n_fft // 2 + 1):  # every bin, in bin order
        dense = dense + mag[:, k, None] * mel_w[k]
    ranged = np.zeros((6, n_mels))
    for m, (lo, hi) in enumerate(bins):
        for k in range(lo, hi):  # the kernel's sum, in bin order
            ranged[:, m] = ranged[:, m] + mag[:, k] * mel_w[k, m]
    np.testing.assert_array_equal(ranged, dense)
    np.testing.assert_allclose(ranged, mag @ mel_w, rtol=1e-12)
    consts = pmel.MelSpectrogram(filter_length=n_fft, hop_length=n_fft // 4,
                                 win_length=n_fft, n_mel_channels=n_mels,
                                 sampling_rate=sr, mel_fmin=fmin,
                                 mel_fmax=fmax, device="cpu").consts
    np.testing.assert_array_equal(consts.mel_bins.numpy(), bins)
