"""Port parity of the audio front end: gantron_tpu_torch's filters, STFT,
Griffin-Lim, mel featurizer and dB features against the JAX package's.

Inputs are made with numpy from seeds and given to both sides. Tolerances:
the numpy filter copies are bit-equal; the STFT and its inverse agree to
1e-4 (float32 sums in another order); Griffin-Lim to 1e-3 after 2
iterations from the same initial phases (drawn with ``jax.random.uniform``
as gantron_tpu/audio/stft.py:131 draws them); log-mels to 2e-3, as in
tests/test_pallas_mel.py (near the 1e-5 clip floor the log turns tiny
spectrum differences into large ones). On the CPU the mel wrapper is its
plain version; the kernel is held against it on the card by chip_smoke.py.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gantron_tpu.audio import filters as jf
from gantron_tpu.audio import mel as jmel
from gantron_tpu.audio import stft as jstft
from gantron_tpu.ops.pallas_mel import pallas_mel_spectrogram
from gantron_tpu_torch.audio import filters as pf
from gantron_tpu_torch.audio import mel as pmel
from gantron_tpu_torch.audio import stft as pstft
from gantron_tpu_torch.ops import mel as pops
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wave(shape, seed):
    rng = np.random.RandomState(seed)
    return np.clip(rng.randn(*shape) * 0.2, -1, 1).astype(np.float32)


@pytest.mark.parametrize("cfg", [(22050, 1024, 80, 0.0, 8000.0),
                                 (22050, 1024, 80, 0.0, None),
                                 (16000, 512, 40, 50.0, 7000.0)])
def test_filters_bit_equal(cfg):
    sr, n_fft, n_mels, fmin, fmax = cfg
    np.testing.assert_array_equal(
        pf.mel_filterbank(sr, n_fft, n_mels, fmin, fmax),
        jf.mel_filterbank(sr, n_fft, n_mels, fmin, fmax))
    hz = np.array([0.0, 440.0, 1000.0, 4000.0])
    np.testing.assert_array_equal(pf.hz_to_mel(hz), jf.hz_to_mel(hz))
    np.testing.assert_array_equal(pf.mel_to_hz(pf.hz_to_mel(hz)),
                                  jf.mel_to_hz(jf.hz_to_mel(hz)))
    for win in (n_fft, n_fft // 2 + 6):
        np.testing.assert_array_equal(pf.hann_window(win),
                                      jf.hann_window(win))
        np.testing.assert_array_equal(
            pf.pad_center(pf.hann_window(win, np.float64), n_fft),
            jf.pad_center(jf.hann_window(win, np.float64), n_fft))
        np.testing.assert_array_equal(
            pf.window_sumsquare(win, 7, n_fft // 4, n_fft),
            jf.window_sumsquare(win, 7, n_fft // 4, n_fft))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 300, 513, 2000])
def test_reflect_pad_reflects_again_like_numpy(n):
    y = _wave((2, n), n)
    for pad in (1, 5, 512):
        np.testing.assert_array_equal(
            pops.reflect_pad(torch.from_numpy(y), pad).numpy(),
            np.pad(y, ((0, 0), (pad, pad)), mode="reflect"))


# The JAX package's STFT takes an SVD of its Fourier matrix in every
# constructor: build each configuration once.
_jax_stft = functools.lru_cache(maxsize=None)(jstft.STFT)
_jax_mel = functools.lru_cache(maxsize=None)(jmel.MelSpectrogram)


def _stfts(**kw):
    return _jax_stft(**kw), pstft.STFT(device="cpu", **kw)


def _float64_magnitude(y, js):
    """|STFT| of ``y`` in float64: numpy's reflect pad and framing, the
    JAX STFT's windowed basis widened to float64."""
    n_fft, hop = js.filter_length, js.hop_length
    yp = np.pad(y.astype(np.float64), ((0, 0), (n_fft // 2, n_fft // 2)),
                mode="reflect")
    T = js.n_frames(y.shape[1])
    frames = np.stack([yp[:, t * hop: t * hop + n_fft] for t in range(T)],
                      axis=1)
    spec = frames @ np.asarray(js.forward_basis, np.float64)
    return np.hypot(spec[..., :js.cutoff], spec[..., js.cutoff:]) \
        .transpose(0, 2, 1)


def _where_off(mag, ref):
    """Which (sample, frame) rows of the frames @ basis product are off,
    with the process's torch threading and matmul settings, for the log of
    a failure (the port's side failed in parallel runs only, on about 3 of
    its 34 rows: ROADMAP.md §3)."""
    err = np.abs(mag - ref).max(axis=1)  # (B, frames)
    rows = [(int(b), int(t), float(err[b, t]))
            for b, t in zip(*np.nonzero(err > 1e-4))]
    return (f"rows off (sample, frame, max error): {rows}\n"
            f"float32 matmul precision "
            f"{torch.get_float32_matmul_precision()}, threads "
            f"{torch.get_num_threads()}\n{torch.__config__.parallel_info()}")


@pytest.mark.parametrize("kw", [{}, dict(filter_length=256, hop_length=64,
                                         win_length=200)])
def test_stft_transform_magnitude_inverse_match_jax(kw):
    js, ps = _stfts(**kw)
    y = _wave((2, 4096), 1)
    j_mag, j_phase = (np.array(a) for a in js.transform(jnp.asarray(y)))
    p_mag, p_phase = (a.numpy() for a in ps.transform(torch.from_numpy(y)))
    assert p_mag.shape == j_mag.shape == (2, js.cutoff, js.n_frames(4096))
    # Each side against the float64 magnitude first, so that a failure
    # names the side that moved (this comparison failed intermittently in
    # parallel runs; ROADMAP.md §3).
    ref = _float64_magnitude(y, js)
    np.testing.assert_allclose(j_mag, ref, atol=1e-4, err_msg="JAX")
    np.testing.assert_allclose(p_mag, ref, atol=1e-4,
                               err_msg="port\n" + _where_off(p_mag, ref))
    np.testing.assert_allclose(p_mag, j_mag, atol=1e-4)
    # Phases are compared as the spectrum they give: atan2 of a bin whose
    # imaginary part is +-0 (bin 0) may be +-pi on either side.
    for f in (np.cos, np.sin):
        np.testing.assert_allclose(p_mag * f(p_phase), j_mag * f(j_phase),
                                   atol=1e-4)
    np.testing.assert_allclose(ps.magnitude(torch.from_numpy(y)).numpy(),
                               np.asarray(js.magnitude(jnp.asarray(y))),
                               atol=1e-4)
    j_inv = np.asarray(js.inverse(jnp.asarray(j_mag), jnp.asarray(j_phase)))
    p_inv = ps.inverse(torch.from_numpy(j_mag),
                       torch.from_numpy(j_phase)).numpy()
    assert p_inv.shape == j_inv.shape
    np.testing.assert_allclose(p_inv, j_inv, atol=1e-4)


def _jax_angles(shape, seed):
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                       minval=-np.pi, maxval=np.pi,
                                       dtype=jnp.float32))


def test_griffin_lim_matches_jax_from_the_same_phases():
    js, ps = _stfts(filter_length=256, hop_length=64, win_length=256)
    mag = np.abs(np.random.RandomState(2).randn(2, js.cutoff, 12)) \
        .astype(np.float32)
    j = np.asarray(jstft.griffin_lim(jnp.asarray(mag), js, n_iters=2,
                                     key=jax.random.PRNGKey(3)))
    p = pstft.griffin_lim(torch.from_numpy(mag), ps, n_iters=2,
                          angles=torch.from_numpy(_jax_angles(mag.shape, 3)))
    assert p.shape == j.shape == (2, 11 * 64)
    np.testing.assert_allclose(p.numpy(), j, atol=1e-3)


@pytest.mark.parametrize("frames", [1, 3, 9])
def test_mel_to_wav_griffin_lim_matches_jax(frames):
    kw = dict(filter_length=256, hop_length=64, win_length=256,
              n_mel_channels=20, sampling_rate=8000, mel_fmax=4000.0)
    jm, pm = _jax_mel(**kw), pmel.MelSpectrogram(device="cpu", **kw)
    mel = (np.random.RandomState(frames).randn(1, 20, frames) - 4.0) \
        .astype(np.float32)
    padded = (1, 256 // 2 + 1, max(frames, 256 // 64 + 1))
    j = np.asarray(jmel.mel_to_wav_griffin_lim(
        jnp.asarray(mel), jm, n_iters=2, key=jax.random.PRNGKey(frames)))
    p = pmel.mel_to_wav_griffin_lim(
        torch.from_numpy(mel), pm, n_iters=2,
        angles=torch.from_numpy(_jax_angles(padded, frames))).numpy()
    expected = min(frames, max(frames, 5) - 1) * 64
    assert p.shape == j.shape == (1, expected)
    np.testing.assert_allclose(p, j, atol=1e-3)


@pytest.mark.parametrize("shape,seed", [((2, 8192), 0), ((1, 5000), 1),
                                        ((1, 300), 2)])
def test_mel_matches_jax_xla_and_pallas(shape, seed):
    """8192: whole 128-frame tiles on the TPU side; 5000 samples: 20
    frames, no tile multiple; 300 samples: shorter than the 512-sample pad,
    so the reflection repeats."""
    y = _wave(shape, seed)
    ref = np.asarray(_jax_mel()(jnp.asarray(y)))
    fused = np.asarray(pallas_mel_spectrogram(jnp.asarray(y),
                                              interpret=True))
    consts = pmel.MelSpectrogram(device="cpu").consts
    yt = torch.from_numpy(y)
    plain = pops.log_mel_plain(pops.reflect_pad(yt, 512), consts).numpy()
    port = pmel.MelSpectrogram(device="cpu")(yt).numpy()
    assert plain.shape == ref.shape == fused.shape
    np.testing.assert_allclose(plain, ref, atol=2e-3)
    np.testing.assert_allclose(plain, fused, atol=2e-3)
    np.testing.assert_array_equal(port, plain)
    assert pmel.MelSpectrogram(device="cpu").n_frames(shape[1]) \
        == _jax_mel().n_frames(shape[1]) == ref.shape[2]


def test_mel_constants_match_the_pallas_kernels():
    from gantron_tpu.ops.pallas_mel import _constants

    basis, mel_w, kp, mp = _constants(1024, 256, 1024, 80, 22050, 0.0,
                                      8000.0)
    mel_fn = pmel.MelSpectrogram(device="cpu")
    consts = mel_fn.consts
    nb = 513
    np.testing.assert_array_equal(consts.basis[:, :nb].numpy(),
                                  np.asarray(basis)[:, :nb])
    np.testing.assert_array_equal(consts.basis[:, nb:].numpy(),
                                  np.asarray(basis)[:, kp:kp + nb])
    np.testing.assert_array_equal(consts.mel_w.numpy(),
                                  np.asarray(mel_w)[:nb, :80])
    # One copy of each constant: the kernel's operands are the STFT's basis
    # and the filterbank that mel_basis views.
    assert consts.basis is mel_fn.stft.forward_basis
    assert consts.mel_w.data_ptr() == mel_fn.mel_basis.data_ptr()
    np.testing.assert_array_equal(mel_fn.mel_basis.numpy(),
                                  np.asarray(_jax_mel().mel_basis))


def test_dynamic_range_functions_match_jax():
    x = np.abs(np.random.RandomState(3).randn(4, 7)).astype(np.float32)
    x[0, :3] = [0.0, 1e-7, 1e-5]
    np.testing.assert_allclose(
        pmel.dynamic_range_compression(torch.from_numpy(x)).numpy(),
        np.asarray(jmel.dynamic_range_compression(jnp.asarray(x))),
        rtol=1e-6)
    np.testing.assert_allclose(
        pmel.dynamic_range_decompression(torch.from_numpy(x)).numpy(),
        np.asarray(jmel.dynamic_range_decompression(jnp.asarray(x))),
        rtol=1e-6)


@pytest.mark.parametrize("ref_axis", [None, (-2, -1)])
def test_power_to_db_matches_jax(ref_axis):
    S = np.abs(np.random.RandomState(4).randn(3, 5, 9)).astype(np.float32)
    S[1] *= 100.0
    S[2, 0, :4] = 0.0
    np.testing.assert_allclose(
        pmel.power_to_db(torch.from_numpy(S), ref_axis=ref_axis).numpy(),
        np.asarray(jmel.power_to_db(jnp.asarray(S), ref_axis=ref_axis)),
        atol=1e-4)


def test_power_mel_db_matches_jax():
    y = _wave((2, 6000), 5)
    y[1] *= 0.01  # a quiet utterance keeps its own dB scale
    ref = np.asarray(jmel.PowerMelDB()(jnp.asarray(y)))
    port = pmel.PowerMelDB(device="cpu")(torch.from_numpy(y)).numpy()
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, atol=2e-3)


def test_log_mel_on_cpu_is_the_plain_version_and_launches_nothing():
    consts = pmel.MelSpectrogram(device="cpu").consts
    yp = pops.reflect_pad(torch.from_numpy(_wave((2, 3000), 6)), 512)
    before = pops.log_mel.launches
    np.testing.assert_array_equal(pops.log_mel(yp, consts).numpy(),
                                  pops.log_mel_plain(yp, consts).numpy())
    assert pops.log_mel.launches == before == 0
    with pytest.raises(ValueError):
        pops.log_mel(torch.ones(1, 2048, device="meta"), consts)


def test_mel_imports_without_triton_or_nvcc():
    """Importing the mel wrapper (and its CPU path) needs neither triton
    nor nvcc: nothing is built or imported until a CUDA tensor arrives."""
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import torch\n"
        "from gantron_tpu_torch.ops import mel\n"
        "from gantron_tpu_torch.audio import MelSpectrogram\n"
        "out = MelSpectrogram(device='cpu')(torch.zeros(1, 4000))\n"
        "from gantron_tpu_torch.utils import cuda_build\n"
        "assert out.shape == (1, 80, 16)\n"
        "assert mel.log_mel.launches == 0 and not cuda_build._libs\n")
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent",
               PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO)
