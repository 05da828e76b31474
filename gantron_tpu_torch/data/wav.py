"""WAV loading without librosa/soundfile.

Equivalent of the reference's ``load_wav_to_torch`` (utils.py:27-31):
decode -> mono -> resample to target rate -> float32, renormalized to
[-1, 1] if out of range. Pure numpy RIFF parsing + scipy polyphase
resampling.
"""

import os
import struct

import numpy as np
from scipy.signal import resample_poly


def read_wav(path):
    """Parse a RIFF/WAVE file. Returns (float32 array (T,) or (T, C), rate).

    Supports PCM 8/16/24/32-bit and IEEE float32/64.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 0xFFFE:
        # WAVE_FORMAT_EXTENSIBLE: the real format is the first 2 bytes of
        # the SubFormat GUID at offset 24 of the fmt body (cbSize at 16,
        # validBits/channelMask at 18/20). Extensible float32 wavs are
        # common from DAW/sox output; guessing PCM from the bit depth would
        # misdecode float bit patterns as int32 garbage.
        if len(fmt_body) >= 26:
            audio_format = struct.unpack("<H", fmt_body[24:26])[0]
        else:
            audio_format = 1 if bits in (8, 16, 24) else 3

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 8:
            x = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, "u1").reshape(-1, 3)
            x = ((b[:, 0].astype(np.int32))
                 | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32)
            x /= float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported PCM bits={bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(
            np.float32)
    else:
        raise ValueError(f"{path}: unsupported format {audio_format}")

    if channels > 1:
        x = x[: len(x) - len(x) % channels].reshape(-1, channels)
    return x, rate


def wav_info(path):
    """(num_samples, rate) from the RIFF headers only — no decode. Used for
    length-aware batch sorting."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        rate = None
        block_align = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            chunk_id = hdr[:4]
            size = struct.unpack("<I", hdr[4:8])[0]
            if chunk_id == b"fmt ":
                body = f.read(16)
                if len(body) < 16:
                    raise ValueError(f"{path}: truncated fmt chunk")
                _, channels, rate, _, block_align, _ = struct.unpack(
                    "<HHIIHH", body)
                f.seek(size - 16 + (size & 1), 1)
            elif chunk_id == b"data":
                if rate is None:
                    raise ValueError(f"{path}: data chunk before fmt")
                return size // max(block_align or 1, 1), rate
            else:
                f.seek(size + (size & 1), 1)
    raise ValueError(f"{path}: missing fmt/data chunk")


def write_wav(path, audio, rate=22050):
    """Write mono float32 [-1, 1] audio as PCM16 (soundfile.write equiv).

    Atomic (temp + rename): a concurrent reader — e.g. a live training run
    whose corpus an evaluation script re-materializes — never sees a
    truncated RIFF file.
    """
    audio = np.asarray(audio, np.float32)
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2").tobytes()
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2,
                                      2, 16))
        f.write(b"data" + struct.pack("<I", len(pcm)) + pcm)
    os.replace(tmp, path)


def load_wav(path, sampling_rate=22050):
    """Load, mono-ize, resample, renormalize — float32 (T,) in [-1, 1]."""
    x, rate = read_wav(path)
    if x.ndim == 2:
        x = x.mean(axis=1)
    if rate != sampling_rate:
        g = np.gcd(int(rate), int(sampling_rate))
        x = resample_poly(x, sampling_rate // g, rate // g).astype(np.float32)
    peak = max(abs(float(x.min(initial=0.0))), abs(float(x.max(initial=0.0))))
    if peak > 1.0:
        x = x / peak
    return x.astype(np.float32)
