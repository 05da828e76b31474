"""Toy "tone language" corpus: each character maps to a distinct sine
frequency, so text and audio are genuinely correlated and attention
alignment is learnable in minutes. Used by the e2e wav-training test and
the alignment-emergence demo (docs/alignment_demo.md); real training uses
LJSpeech/VESUS via the same filelist format (reference data_utils.py:13-79).
"""

import os

import numpy as np

from gantron_tpu_torch.data.wav import write_wav

SR = 22050
CHARS = "aeiou mnst"
CHAR_SAMPLES = 1536  # ~70 ms per character


def _emit_wav(path, audio):
    """Idempotent corpus-wav write. The seeded builders always synthesize
    the same bytes for a given path, so an existing file is left untouched:
    re-materializing a corpus next to a LIVE training run (e.g.
    mode_attribution --probe's anchor fallback) must not rewrite files the
    run is reading. (write_wav itself is atomic, so even a fresh write
    never exposes a truncated RIFF.)"""
    if not os.path.exists(path):
        write_wav(path, audio, SR)


def _write_filelist(path, lines):
    """Atomic filelist write; an empty split yields an empty FILE, not a
    lone blank line (loaders skip blanks, but a 0-entry val set should
    look empty everywhere, including to `wc -l`)."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    os.replace(tmp, path)


def synth_utterance(text: str, rng) -> np.ndarray:
    """Each char -> a fixed-frequency tone burst; space -> near-silence."""
    parts = []
    for ch in text:
        idx = CHARS.index(ch)
        t = np.arange(CHAR_SAMPLES) / SR
        freq = 180.0 * (1.3 ** idx)
        amp = 0.02 if ch == " " else 0.5
        burst = amp * np.sin(2 * np.pi * freq * t)
        burst *= np.hanning(CHAR_SAMPLES) ** 0.25  # soften edges
        parts.append(burst)
    wav = np.concatenate(parts)
    return (wav + rng.randn(wav.size) * 0.003).astype(np.float32)


EMOTIONS = ["Neutral", "Angry", "Happy", "Sad", "Fearful"]

# Audible, mel-visible per-emotion modulations of the tone language. Chosen
# so each emotion survives Griffin-Lim vocoding + classifier-style dB mel
# re-extraction: pitch scale, harmonics, vibrato (FM), tremolo (AM), level.
_EMOTION_FX = {
    "Neutral": dict(pitch=1.0, amp=1.0, harm=0.0, vib=0.0, trem=0.0, nz=1.0),
    "Angry": dict(pitch=1.45, amp=1.1, harm=0.5, vib=0.0, trem=0.0, nz=1.0),
    "Happy": dict(pitch=1.0, amp=1.0, harm=0.0, vib=0.05, trem=0.0, nz=1.0),
    "Sad": dict(pitch=0.72, amp=0.6, harm=0.0, vib=0.0, trem=0.0, nz=1.0),
    "Fearful": dict(pitch=1.0, amp=0.9, harm=0.0, vib=0.0, trem=0.8, nz=4.0),
}

_SPEAKER_PITCH = [1.0, 1.19]  # per-speaker global pitch offset


def synth_emotive_utterance(text: str, emotion: str, speaker: int,
                            rng) -> np.ndarray:
    """Tone-language synthesis with emotion/speaker modulation: text still
    maps to a diagonal alignment (fixed per-char duration) while the
    emotion audibly changes pitch/timbre/FM/AM, so both attention AND
    emotion controllability are learnable (and measurable by the
    study_model pipeline) on this corpus."""
    fx = _EMOTION_FX[emotion]
    spk_pitch = _SPEAKER_PITCH[speaker % len(_SPEAKER_PITCH)]
    parts = []
    t = np.arange(CHAR_SAMPLES) / SR
    for k, ch in enumerate(text):
        idx = CHARS.index(ch)
        freq = 180.0 * (1.3 ** idx) * fx["pitch"] * spk_pitch
        amp = (0.02 if ch == " " else 0.5) * fx["amp"]
        t_abs = t + k * CHAR_SAMPLES / SR  # continuous mod phase
        if fx["vib"]:
            phase = 2 * np.pi * freq * t * (
                1.0 + fx["vib"] * np.sin(2 * np.pi * 6.0 * t_abs))
        else:
            phase = 2 * np.pi * freq * t
        burst = np.sin(phase)
        if fx["harm"]:
            burst = burst + fx["harm"] * np.sin(2 * phase)
        if fx["trem"]:
            burst = burst * (1.0 - fx["trem"] * 0.5
                             * (1 + np.sin(2 * np.pi * 7.0 * t_abs)))
        burst = amp * burst
        burst *= np.hanning(CHAR_SAMPLES) ** 0.25
        parts.append(burst)
    wav = np.concatenate(parts)
    noise = rng.randn(wav.size) * 0.003 * fx["nz"]
    return (wav + noise).astype(np.float32)


def build_emotive_corpus(root: str, n_utts: int = 300, n_train: int = None,
                         min_chars: int = 5, max_chars: int = 9,
                         n_speakers: int = 2, seed: int = 0):
    """Write a VESUS-layout emotive tone corpus under ``root``:

      Audio/<Emotion>/<speaker>/u<i>.wav
      train.txt / val.txt rows: relpath|text|speaker|e0,e1,e2,e3,e4
      lj_empty.txt (empty LJSpeech filelist so TextMelDataset's merged
      two-filelist interface works VESUS-only)

    Returns (vesus_root_with_sep, lj_empty, train_filelist, val_filelist).
    The layout matches what ``load_vesus(use_labels='intended')`` expects
    (emotion from the directory name, reference utils.py:96-102) and the
    vector column serves 'multi' mode.
    """
    n_train = n_train if n_train is not None else max(n_utts - 20, 1)
    rng = np.random.RandomState(seed)
    letters = list(CHARS.strip())
    lines = []
    for i in range(n_utts):
        emotion = EMOTIONS[i % len(EMOTIONS)]
        speaker = (i // len(EMOTIONS)) % n_speakers
        n_chars = rng.randint(min_chars, max_chars)
        text = "".join(rng.choice(letters) for _ in range(n_chars))
        rel = f"Audio/{emotion}/{speaker}/u{i}.wav"
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _emit_wav(path, synth_emotive_utterance(text, emotion, speaker,
                                                rng))
        onehot = [1.0 if e == emotion else 0.0 for e in EMOTIONS]
        vec = ",".join(str(v) for v in onehot)
        lines.append(f"{rel}|{text}|{speaker}|{vec}")
    # Interleaved emotions + round-robin speakers -> both splits cover all
    # emotion/speaker combinations.
    train_list = os.path.join(root, "train.txt")
    val_list = os.path.join(root, "val.txt")
    lj_empty = os.path.join(root, "lj_empty.txt")
    _write_filelist(train_list, lines[:n_train])
    _write_filelist(val_list, lines[n_train:])
    open(lj_empty, "w").close()
    return root + os.sep, lj_empty, train_list, val_list


# --- One-to-many ("bimodal") corpus: GAN-vs-MSE mode-commitment study ---
#
# GANtron's thesis is that noise injection makes text->mel one-to-many
# (reference model.py:184-191, 273-279; README.md:5-9). To give the
# adversarial path something MSE provably cannot do, each utterance here
# randomly carries (mode B) or lacks (mode A) a high-band noise texture
# that appears NOWHERE in the text or conditioning. The MSE-optimal
# free-running prediction is the conditional mean (half-energy high band —
# a mel that matches NO real utterance); a GAN generator can use its noise
# vector to commit to one mode per draw. ``hiband_mode_stats`` below is the
# measurement.

HIBAND_LO_HZ = 5000.0
HIBAND_AMP = 0.25


def synth_bimodal_utterance(text: str, mode: int, rng) -> np.ndarray:
    """Tone-language utterance; ``mode=1`` adds a band-limited 5-8 kHz
    noise texture (amplitude-modulated by the char envelope so it reads as
    utterance texture, not background)."""
    wav = synth_utterance(text, rng)
    if mode:
        # Band-limit white noise to >= HIBAND_LO_HZ with an FFT brickwall:
        # exact, dependency-free, and well above every char tone
        # (max char fundamental ~1.9 kHz, 2nd harmonic ~3.8 kHz).
        noise = _bandlimited_noise(wav.size, HIBAND_LO_HZ, None, rng)
        envelope = np.abs(wav) + 0.05
        wav = wav + HIBAND_AMP * noise * envelope
    return wav.astype(np.float32)


def build_bimodal_corpus(root: str, n_utts: int = 200, n_train: int = None,
                         min_chars: int = 5, max_chars: int = 9,
                         seed: int = 0):
    """LJSpeech-layout corpus where ~half the utterances (random, hidden
    from text/labels) carry the high-band texture. Returns
    (wav_dir_with_sep, train_filelist, val_filelist, modes) where ``modes``
    maps wav filename -> mode for evaluation code."""
    n_train = n_train if n_train is not None else max(n_utts - 10, 1)
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    letters = list(CHARS.strip())
    lines = []
    modes = {}
    for i in range(n_utts):
        n_chars = rng.randint(min_chars, max_chars)
        text = "".join(rng.choice(letters) for _ in range(n_chars))
        mode = int(rng.rand() < 0.5)
        name = f"u{i}.wav"
        _emit_wav(os.path.join(wav_dir, name),
                  synth_bimodal_utterance(text, mode, rng))
        modes[name] = mode
        lines.append(f"{name}|{text}")
    train_list = os.path.join(root, "train.txt")
    val_list = os.path.join(root, "val.txt")
    _write_filelist(train_list, lines[:n_train])
    _write_filelist(val_list, lines[n_train:])
    return wav_dir + os.sep, train_list, val_list, modes


# --- Stochastic-texture corpus: GAN-vs-MSE per-frame sharpness study ---
#
# The bimodal corpus above tests MODE SELECTION (one global hidden bit per
# utterance). This corpus tests PER-FRAME TEXTURE: the high-band amplitude
# is re-drawn i.i.d. every mel frame, so it is unpredictable from text,
# labels, AND all history. The MSE-optimal prediction is the constant
# conditional mean — a flat high band with near-zero frame-to-frame
# variability; matching the real distribution requires per-frame variance
# that only an adversarial (distribution-matching) objective rewards. The
# measurement is the within-utterance temporal spread of the high-band
# level (eval.mode_study.hiband_series).

# Amplitude block size in samples. 2x the 256-sample mel hop: the 1024-wide
# STFT window averages ~4 hops, so per-hop draws wash out (measured
# within-utterance hiband std 0.29 at 256 vs 0.49 at 512 with the fastest
# frame-to-frame movement; 1024 is larger-std but slower-moving).
TEXTURE_HOP = 512


def synth_texture_utterance(text: str, rng) -> np.ndarray:
    """Tone-language utterance + >=5 kHz noise whose amplitude is redrawn
    uniformly at every ``TEXTURE_HOP``-sample block."""
    wav = synth_utterance(text, rng)
    noise = _bandlimited_noise(wav.size, HIBAND_LO_HZ, None, rng)
    n_frames = (wav.size + TEXTURE_HOP - 1) // TEXTURE_HOP
    amps = rng.rand(n_frames).astype(np.float32)  # i.i.d. per frame
    amp_per_sample = np.repeat(amps, TEXTURE_HOP)[: wav.size]
    wav = wav + 2.0 * HIBAND_AMP * noise * amp_per_sample
    return wav.astype(np.float32)


def build_texture_corpus(root: str, n_utts: int = 200, n_train: int = None,
                         min_chars: int = 5, max_chars: int = 9,
                         seed: int = 0):
    """LJSpeech-layout corpus with i.i.d. per-frame high-band texture.
    Returns (wav_dir_with_sep, train_filelist, val_filelist)."""
    n_train = n_train if n_train is not None else max(n_utts - 10, 1)
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    letters = list(CHARS.strip())
    lines = []
    for i in range(n_utts):
        n_chars = rng.randint(min_chars, max_chars)
        text = "".join(rng.choice(letters) for _ in range(n_chars))
        _emit_wav(os.path.join(wav_dir, f"u{i}.wav"),
                  synth_texture_utterance(text, rng))
        lines.append(f"u{i}.wav|{text}")
    train_list = os.path.join(root, "train.txt")
    val_list = os.path.join(root, "val.txt")
    _write_filelist(train_list, lines[:n_train])
    _write_filelist(val_list, lines[n_train:])
    return wav_dir + os.sep, train_list, val_list


# --- Composed corpus: BOTH hidden factors in one signal ---
#
# The bimodal corpus tests mode SELECTION, the texture corpus tests
# per-frame TEXTURE; each study trained a different model. This corpus
# carries both factors on disjoint frequency bands so ONE trained model can
# be scored on identification (latent controls the mode) AND texture
# recovery (adversarial loss reproduces the unpredictable variance):
#   * mode bit (hidden from text/labels): a steady band-limited noise in
#     [4.0, 4.8] kHz — 6 mel channels centered 4008-4856 Hz.
#   * per-frame texture (always on): i.i.d. per-block amplitude noise
#     >= 5.4 kHz — scored on the 10 mel channels centered >= 5449 Hz.
# Two buffer channels (centers 5046 and 5244 Hz) separate the bands, so
# the 4.8 kHz marker's triangle (ends ~5244 Hz) never reaches the texture
# scoring band and vice versa.

MODEBAND_LO_HZ = 4000.0
MODEBAND_HI_HZ = 4800.0
TEXBAND_LO_HZ = 5400.0
# Scoring bands (mel channel selection) — slightly inside the signal bands.
MODEBAND_SCORE = (3900.0, 4900.0)
TEXBAND_SCORE = 5300.0


def _bandlimited_noise(n: int, lo_hz: float, hi_hz, rng) -> np.ndarray:
    """Unit-std FFT-brickwall noise restricted to [lo_hz, hi_hz)
    (``hi_hz=None`` = no upper cut, keeping even the Nyquist bin — the
    bimodal/texture corpora were generated that way and their committed
    study artifacts must stay byte-reproducible)."""
    noise = rng.randn(n).astype(np.float32)
    spec = np.fft.rfft(noise)
    freqs = np.fft.rfftfreq(n, 1.0 / SR)
    keep_out = freqs < lo_hz
    if hi_hz is not None:
        keep_out |= freqs >= hi_hz
    spec[keep_out] = 0
    noise = np.fft.irfft(spec, n=n).astype(np.float32)
    return noise / max(np.std(noise), 1e-6)


def synth_composed_utterance(text: str, mode: int, rng) -> np.ndarray:
    """Tone-language utterance + (mode ? steady [4.0,4.8] kHz marker : 0)
    + i.i.d. per-block >=5.4 kHz texture (always)."""
    wav = synth_utterance(text, rng)
    envelope = np.abs(wav) + 0.05
    if mode:
        marker = _bandlimited_noise(wav.size, MODEBAND_LO_HZ,
                                    MODEBAND_HI_HZ, rng)
        wav = wav + HIBAND_AMP * marker * envelope
    tex = _bandlimited_noise(wav.size, TEXBAND_LO_HZ, SR / 2.0, rng)
    n_blocks = (wav.size + TEXTURE_HOP - 1) // TEXTURE_HOP
    amps = rng.rand(n_blocks).astype(np.float32)
    amp_per_sample = np.repeat(amps, TEXTURE_HOP)[: wav.size]
    wav = wav + 2.0 * HIBAND_AMP * tex * amp_per_sample
    return wav.astype(np.float32)


def build_composed_corpus(root: str, n_utts: int = 200, n_train: int = None,
                          min_chars: int = 5, max_chars: int = 9,
                          seed: int = 0):
    """LJSpeech-layout corpus carrying BOTH hidden factors (mode bit on
    [4.0,4.8] kHz, i.i.d. per-frame texture >=5.4 kHz). Returns
    (wav_dir_with_sep, train_filelist, val_filelist, modes)."""
    n_train = n_train if n_train is not None else max(n_utts - 10, 1)
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    letters = list(CHARS.strip())
    lines = []
    modes = {}
    for i in range(n_utts):
        n_chars = rng.randint(min_chars, max_chars)
        text = "".join(rng.choice(letters) for _ in range(n_chars))
        mode = int(rng.rand() < 0.5)
        name = f"u{i}.wav"
        _emit_wav(os.path.join(wav_dir, name),
                  synth_composed_utterance(text, mode, rng))
        modes[name] = mode
        lines.append(f"{name}|{text}")
    train_list = os.path.join(root, "train.txt")
    val_list = os.path.join(root, "val.txt")
    _write_filelist(train_list, lines[:n_train])
    _write_filelist(val_list, lines[n_train:])
    return wav_dir + os.sep, train_list, val_list, modes


# --- Factorial corpus: TWO independent hidden bits on disjoint bands ---
#
# The bimodal corpus carries ONE hidden bit; this corpus carries two,
# drawn independently per utterance, so the latent space to identify is a
# 2x2 product (4 joint modes at ~uniform probability). Bit A reuses the
# composed corpus's mode band ([4.0, 4.8] kHz, scored on MODEBAND_SCORE);
# bit B is a STEADY marker on the texture corpus's band (>= 5.4 kHz,
# scored on TEXBAND_SCORE) — the same buffer channels keep the two scoring
# bands disjoint. It is the instrument for the identification-scaling
# study (scripts/gan_factorial_study.py): can a 1-dim 4-level code cover a
# product space, and does a 2-dim 2-level code DISENTANGLE (each code dim
# binding to one bit)? The reference cannot pose the question — its noise
# input is injected but never identified (model.py:184-191, 273-279).


FACTORIAL_LOWPASS_HZ = 3700.0  # below both scoring bands


def synth_factorial_utterance(text: str, bits, rng) -> np.ndarray:
    """Tone-language utterance (lowpassed below the marker bands)
    + (bits[0] ? steady [4.0,4.8] kHz marker : 0)
    + (bits[1] ? steady >=5.4 kHz marker : 0).

    Two instrument-soundness choices differ from the composed corpus:
    the base utterance is brickwall-lowpassed at 3.7 kHz so the off-bit
    level in each scoring band is the quiet mel floor (per-text tone
    splatter otherwise puts ~0.6 log-units of spread there, blurring the
    class separation), and the markers are added at CONSTANT amplitude
    (an |wav| envelope would amplitude-modulate the marker, and the
    high-tone envelope harmonics reach ~3.8 kHz — wide enough sidebands
    to leak bit B's >=5.4 kHz marker into bit A's band, breaking
    independence)."""
    wav = synth_utterance(text, rng)
    spec = np.fft.rfft(wav)
    freqs = np.fft.rfftfreq(wav.size, 1.0 / SR)
    spec[freqs >= FACTORIAL_LOWPASS_HZ] = 0
    wav = np.fft.irfft(spec, n=wav.size).astype(np.float32)
    amp = HIBAND_AMP * (float(np.abs(wav).mean()) + 0.05)
    if bits[0]:
        marker = _bandlimited_noise(wav.size, MODEBAND_LO_HZ,
                                    MODEBAND_HI_HZ, rng)
        wav = wav + amp * marker
    if bits[1]:
        marker = _bandlimited_noise(wav.size, TEXBAND_LO_HZ, SR / 2.0, rng)
        wav = wav + amp * marker
    return wav.astype(np.float32)


def build_factorial_corpus(root: str, n_utts: int = 200, n_train: int = None,
                           min_chars: int = 5, max_chars: int = 9,
                           seed: int = 0):
    """LJSpeech-layout corpus with two independent hidden bits (bit A on
    [4.0,4.8] kHz, bit B >= 5.4 kHz; both hidden from text/labels).
    Returns (wav_dir_with_sep, train_filelist, val_filelist, bits) where
    ``bits`` maps wav filename -> (bit_a, bit_b)."""
    n_train = n_train if n_train is not None else max(n_utts - 10, 1)
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    letters = list(CHARS.strip())
    lines = []
    bits = {}
    for i in range(n_utts):
        n_chars = rng.randint(min_chars, max_chars)
        text = "".join(rng.choice(letters) for _ in range(n_chars))
        ab = (int(rng.rand() < 0.5), int(rng.rand() < 0.5))
        name = f"u{i}.wav"
        _emit_wav(os.path.join(wav_dir, name),
                  synth_factorial_utterance(text, ab, rng))
        bits[name] = ab
        lines.append(f"{name}|{text}")
    train_list = os.path.join(root, "train.txt")
    val_list = os.path.join(root, "val.txt")
    _write_filelist(train_list, lines[:n_train])
    _write_filelist(val_list, lines[n_train:])
    return wav_dir + os.sep, train_list, val_list, bits


# --- Leveled corpus: ONE CONTINUOUS hidden factor ---
#
# Every identification corpus above hides DISCRETE factors (bits), but the
# reference's designed latent is a continuous noise vector (reference
# model.py:184-191, 273-279) — and the ladder's continuous-code arms were
# only ever tested against binary factors, where the topology mismatch
# (a continuum facing two modes) is itself a confound in the measured
# watermarking. This corpus hides one CONTINUOUS factor: a steady
# [4.0, 4.8] kHz marker whose amplitude sweeps log-uniformly over
# LEVEL_RANGE_OCTAVES octaves with the per-utterance level u ~ U(0,1),
# hidden from text/labels. Log-uniform, because the mel featurizer is
# log-scale: the measured band level (eval.mode_study.hiband_level) is
# then ~LINEAR in u across the whole sweep, instead of compressing all
# u below ~0.5 into the mel floor. Instrument soundness follows the
# factorial corpus: base utterance lowpassed below the band, marker at
# constant (envelope-free) amplitude.

LEVEL_RANGE_OCTAVES = 3.0  # u=0 -> amp/8, u=1 -> amp: an 18 dB sweep


def synth_leveled_utterance(text: str, level: float, rng) -> np.ndarray:
    """Lowpassed tone-language utterance + steady [4.0,4.8] kHz marker at
    amplitude ``2**(-LEVEL_RANGE_OCTAVES*(1-level))`` of the factorial
    corpus's marker amplitude (``level`` in [0, 1])."""
    wav = synth_utterance(text, rng)
    spec = np.fft.rfft(wav)
    freqs = np.fft.rfftfreq(wav.size, 1.0 / SR)
    spec[freqs >= FACTORIAL_LOWPASS_HZ] = 0
    wav = np.fft.irfft(spec, n=wav.size).astype(np.float32)
    amp = HIBAND_AMP * (float(np.abs(wav).mean()) + 0.05)
    amp *= 2.0 ** (-LEVEL_RANGE_OCTAVES * (1.0 - float(level)))
    marker = _bandlimited_noise(wav.size, MODEBAND_LO_HZ,
                                MODEBAND_HI_HZ, rng)
    return (wav + amp * marker).astype(np.float32)


def build_leveled_corpus(root: str, n_utts: int = 200, n_train: int = None,
                         min_chars: int = 5, max_chars: int = 9,
                         seed: int = 0):
    """LJSpeech-layout corpus with one continuous hidden factor (marker
    level u ~ U(0,1) on [4.0,4.8] kHz; hidden from text/labels). Returns
    (wav_dir_with_sep, train_filelist, val_filelist, levels) where
    ``levels`` maps wav filename -> u."""
    n_train = n_train if n_train is not None else max(n_utts - 10, 1)
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    letters = list(CHARS.strip())
    lines = []
    levels = {}
    for i in range(n_utts):
        n_chars = rng.randint(min_chars, max_chars)
        text = "".join(rng.choice(letters) for _ in range(n_chars))
        u = float(rng.rand())
        name = f"u{i}.wav"
        _emit_wav(os.path.join(wav_dir, name),
                  synth_leveled_utterance(text, u, rng))
        levels[name] = u
        lines.append(f"{name}|{text}")
    train_list = os.path.join(root, "train.txt")
    val_list = os.path.join(root, "val.txt")
    _write_filelist(train_list, lines[:n_train])
    _write_filelist(val_list, lines[n_train:])
    return wav_dir + os.sep, train_list, val_list, levels


# --- Bileveled corpus: TWO independent CONTINUOUS hidden factors ---
#
# The leveled corpus proved ONE continuous knob is identifiable; the
# reference's designed latent is a continuous noise VECTOR (reference
# model.py:184-191, 273-279), so the complete claim needs a product of
# continua: two disjoint marker bands (the factorial corpus's bands A and
# B), each with its own independent per-utterance level u ~ U(0,1) on the
# leveled corpus's 18 dB log-sweep. The vector study
# (scripts/gan_vector_study.py) asks whether a 2-dim continuous code
# becomes TWO monotone knobs, each bound to its own band — continuous
# disentanglement, where the factorial study measured the discrete case.


def synth_bileveled_utterance(text: str, level_a: float, level_b: float,
                              rng) -> np.ndarray:
    """Lowpassed tone-language utterance + steady [4.0,4.8] kHz marker at
    level ``level_a`` + steady >=5.4 kHz marker at level ``level_b`` (both
    levels in [0, 1], each scaling its marker by
    ``2**(-LEVEL_RANGE_OCTAVES*(1-level))`` as in the leveled corpus;
    constant marker amplitude and 3.7 kHz base lowpass follow the
    factorial corpus's instrument-soundness choices)."""
    wav = synth_utterance(text, rng)
    spec = np.fft.rfft(wav)
    freqs = np.fft.rfftfreq(wav.size, 1.0 / SR)
    spec[freqs >= FACTORIAL_LOWPASS_HZ] = 0
    wav = np.fft.irfft(spec, n=wav.size).astype(np.float32)
    amp = HIBAND_AMP * (float(np.abs(wav).mean()) + 0.05)
    amp_a = amp * 2.0 ** (-LEVEL_RANGE_OCTAVES * (1.0 - float(level_a)))
    wav = wav + amp_a * _bandlimited_noise(wav.size, MODEBAND_LO_HZ,
                                           MODEBAND_HI_HZ, rng)
    amp_b = amp * 2.0 ** (-LEVEL_RANGE_OCTAVES * (1.0 - float(level_b)))
    wav = wav + amp_b * _bandlimited_noise(wav.size, TEXBAND_LO_HZ,
                                           SR / 2.0, rng)
    return wav.astype(np.float32)


def build_bileveled_corpus(root: str, n_utts: int = 200,
                           n_train: int = None, min_chars: int = 5,
                           max_chars: int = 9, seed: int = 0):
    """LJSpeech-layout corpus with two independent continuous hidden
    factors (marker levels u_a on [4.0,4.8] kHz, u_b on >=5.4 kHz; both
    ~ U(0,1), hidden from text/labels). Returns (wav_dir_with_sep,
    train_filelist, val_filelist, levels) where ``levels`` maps wav
    filename -> (u_a, u_b)."""
    n_train = n_train if n_train is not None else max(n_utts - 10, 1)
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    letters = list(CHARS.strip())
    lines = []
    levels = {}
    for i in range(n_utts):
        n_chars = rng.randint(min_chars, max_chars)
        text = "".join(rng.choice(letters) for _ in range(n_chars))
        ua, ub = float(rng.rand()), float(rng.rand())
        name = f"u{i}.wav"
        _emit_wav(os.path.join(wav_dir, name),
                  synth_bileveled_utterance(text, ua, ub, rng))
        levels[name] = (ua, ub)
        lines.append(f"{name}|{text}")
    train_list = os.path.join(root, "train.txt")
    val_list = os.path.join(root, "val.txt")
    _write_filelist(train_list, lines[:n_train])
    _write_filelist(val_list, lines[n_train:])
    return wav_dir + os.sep, train_list, val_list, levels


def build_corpus(root: str, n_utts: int = 20, n_train: int = None,
                 min_chars: int = 4, max_chars: int = 9, seed: int = 0):
    """Write wavs + LJSpeech-format filelists under ``root``.

    Returns (wav_dir_with_sep, train_filelist, val_filelist).
    """
    n_train = n_train if n_train is not None else max(n_utts - 4, 1)
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    letters = list(CHARS.strip())
    lines = []
    for i in range(n_utts):
        n_chars = rng.randint(min_chars, max_chars)
        text = "".join(rng.choice(letters) for _ in range(n_chars))
        _emit_wav(os.path.join(wav_dir, f"u{i}.wav"),
                  synth_utterance(text, rng))
        lines.append(f"u{i}.wav|{text}")
    train_list = os.path.join(root, "train.txt")
    val_list = os.path.join(root, "val.txt")
    _write_filelist(train_list, lines[:n_train])
    _write_filelist(val_list, lines[n_train:])
    return wav_dir + os.sep, train_list, val_list
