"""Mel filterbank construction (numpy, build-time constants).

Replaces the ``librosa.filters.mel`` dependency (reference: layers.py:84-85)
with a direct implementation of the same Slaney-style filterbank: Slaney mel
scale (linear below 1 kHz, log above), triangular filters, area (slaney)
normalization. Output matches librosa's ``mel(sr, n_fft, n_mels, fmin, fmax)``
with default ``htk=False, norm='slaney'``.
"""

import numpy as np

_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies):
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    mels = frequencies / _F_SP
    if mels.ndim:
        log_t = frequencies >= _MIN_LOG_HZ
        mels[log_t] = _MIN_LOG_MEL + np.log(frequencies[log_t] / _MIN_LOG_HZ) / _LOGSTEP
    elif frequencies >= _MIN_LOG_HZ:
        mels = _MIN_LOG_MEL + np.log(frequencies / _MIN_LOG_HZ) / _LOGSTEP
    return mels


def mel_to_hz(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    if freqs.ndim:
        log_t = mels >= _MIN_LOG_MEL
        freqs[log_t] = _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels[log_t] - _MIN_LOG_MEL))
    elif mels >= _MIN_LOG_MEL:
        freqs = _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL))
    return freqs


def mel_filterbank(sr, n_fft, n_mels=80, fmin=0.0, fmax=None, dtype=np.float32):
    """Triangular mel filterbank, shape (n_mels, 1 + n_fft // 2)."""
    if fmax is None:
        fmax = float(sr) / 2

    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0, float(sr) / 2, n_bins, endpoint=True)

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    mel_f = mel_to_hz(mel_pts)

    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, fftfreqs)

    weights = np.zeros((n_mels, n_bins), dtype=np.float64)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))

    # Slaney-style area normalization: each filter integrates to ~constant.
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, np.newaxis]

    return weights.astype(dtype)


def hann_window(win_length, dtype=np.float32):
    """Periodic Hann window (scipy ``get_window('hann', n, fftbins=True)``)."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return w.astype(dtype)


def pad_center(window, size):
    """Center-pad a window to ``size`` samples (librosa ``pad_center``)."""
    n = len(window)
    if n > size:
        raise ValueError(f"window ({n}) longer than target ({size})")
    lpad = (size - n) // 2
    return np.pad(window, (lpad, size - n - lpad))


def window_sumsquare(win_length, n_frames, hop_length, n_fft,
                     dtype=np.float32):
    """Sum-square envelope of the analysis window (for ISTFT normalization).

    Equivalent to the reference audio_processing.py:7-56 with a Hann window
    and no normalization.
    """
    n = n_fft + hop_length * (n_frames - 1)
    x = np.zeros(n, dtype=np.float64)
    win_sq = pad_center(hann_window(win_length, np.float64) ** 2, n_fft)
    for i in range(n_frames):
        sample = i * hop_length
        x[sample : min(n, sample + n_fft)] += win_sq[: max(0, min(n_fft, n - sample))]
    return x.astype(dtype)
