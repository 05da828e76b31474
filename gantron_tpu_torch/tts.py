"""High-level text-to-speech API (port of gantron_tpu/tts.py).

    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.tts import StreamingSynthesizer, Synthesizer
    synth = Synthesizer(HParams.create("use_noise=True,use_labels=False"))
    synth = Synthesizer.from_checkpoint("out/iter=...ckpt", hp)  # trained
    wav = synth.tts("Hello world.")            # Griffin-Lim
    wav = synth.tts("Hello world.", waveglow)  # neural vocoder
    stream = StreamingSynthesizer(synth.hp, synth.model, waveglow)
    for chunk in stream.stream("Hello world."):  # (1, samples) numpy chunks
        play(chunk)

Runs on the card unless ``device="cpu"`` is passed. Without a ``model`` the
Tacotron2 weights are drawn from ``seed``; ``from_checkpoint`` reads them from
a checkpoint that the port's training loop wrote.
"""

import json
import time
from typing import Optional

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

    @classmethod
    def from_checkpoint(cls, checkpoint_path, hp, device="cuda"):
        """A synthesizer of the generator in ``checkpoint_path`` (written by
        ``train.loop.train``)."""
        from gantron_tpu_torch.utils.loading import load_generator

        return cls(hp, load_generator(checkpoint_path, hp, device), device)

    def load_calibration(self, path_or_json):
        """Attach a measured knob calibration (eval/calibration.py) so that
        ``infer_mel(level=...)`` can target absolute factor levels. Takes a
        path to the calibration's JSON or the JSON string itself, either
        the bare curve (``KnobCalibration.to_json``) or a document holding
        it under "calibration". Returns self."""
        from gantron_tpu_torch.eval.calibration import KnobCalibration

        s = path_or_json
        if not s.lstrip().startswith("{"):
            with open(s) as f:
                s = f.read()
        d = json.loads(s)
        if "calibration" in d and "code_values" not in d:
            d = d["calibration"]
        self.calibration = KnobCalibration.from_json(json.dumps(d))
        return self

    def style_for_level(self, level, seed=0):
        """(1, 1, noise_size) calibrated style that targets an absolute
        factor level (needs :meth:`load_calibration`): a U[0, 1) nuisance
        drawn from the request's noise stream of ``seed`` with the
        calibrated code dim pinned to ``code_for_level(level)``."""
        cal = getattr(self, "calibration", None)
        if cal is None:
            raise ValueError(
                "no knob calibration attached; call load_calibration() "
                "with a KnobCalibration's JSON first")
        return cal.style_for_level(
            level, generator(self.device, _stream_seed(seed, _NOISE)),
            self.hp.noise_size)

    def _ids(self, text, text_lengths=None):
        """(ids (B, T) int64 numpy, text_lengths (B,) int64 numpy) of a str,
        1-D ids or (B, T) ids; lengths from trailing pads unless given."""
        if isinstance(text, str):
            ids = np.asarray(text_to_sequence(text, self.hp.text_cleaners),
                             np.int64)[None]
        else:
            ids = np.asarray(text, np.int64)
            if ids.ndim == 1:
                ids = ids[None]
        if text_lengths is None:
            text_lengths = _derive_text_lengths(ids)
        return ids, np.asarray(text_lengths, np.int64)

    def infer(self, text, style=None, emotions=None, speaker=None, seed=0,
              early_exit=True, text_lengths=None):
        """``Tacotron2.infer`` of a str or ids with this request's random
        streams: [mel, mel_postnet, gate, alignments, mel_lengths]."""
        ids, text_lengths = self._ids(text, text_lengths)
        return self.model.infer(
            torch.from_numpy(ids).to(self.device), style, emotions, speaker,
            None, early_exit, text_lengths=torch.from_numpy(text_lengths),
            generator=generator(self.device, _stream_seed(seed, _DROPOUT)),
            noise_generator=generator(self.device, _stream_seed(seed, _NOISE)))

    def infer_mel(self, text, style=None, emotions=None, speaker=None,
                  seed=0, early_exit=True, text_lengths=None, level=None):
        """Text (str, 1-D ids, or (B, T) ids) -> (mel_postnet (n_mel, L),
        length L) as a tensor on the device. For a (B > 1, T) batch, returns a
        LIST of per-sample (mel, L) pairs.

        ``level``: an absolute factor level for a calibrated style knob
        (needs :meth:`load_calibration`; exclusive with ``style``): one
        ``style_for_level`` style, the same for every row of a batch.

        ``text_lengths``: optional (B,) true lengths of a PADDED id batch;
        derived from trailing pad (id 0) runs when None, so encoder state and
        attention never see pad positions."""
        if level is not None:
            if style is not None:
                raise ValueError("pass either style or level, not both")
            B = self._ids(text, text_lengths)[0].shape[0]
            style = self.style_for_level(level, seed).repeat(B, 1, 1)
        out = self.infer(text, style, emotions, speaker, seed, early_exit,
                         text_lengths)
        mels, lengths = out[1], out[4].tolist()
        if len(lengths) == 1:
            return mels[0, :, :lengths[0]], lengths[0]
        return [(mels[b, :, :L], L) for b, L in enumerate(lengths)]

    def export(self, path, batch_size=1, text_len=96, max_steps=None,
               waveglow=None, sigma=0.666) -> int:
        """Export this model's inference graph (weights held by the program)
        to ``path`` for this synthesizer's device; returns the artifact's
        bytes. See export.py; ``export.load_exported`` serves it."""
        from gantron_tpu_torch.export import export_tts

        return export_tts(self.model, path, batch_size=batch_size,
                          text_len=text_len, max_steps=max_steps,
                          waveglow=waveglow, sigma=sigma, device=self.device)

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


class StreamingSynthesizer(Synthesizer):
    """Chunked text -> wav for a low time to first audio.

    The decoder advances ``chunk`` steps at a time (``infer_segment``); each
    new mel segment goes through the postnet and the vocoder at once, with
    ``lookback`` frames of left context whose samples are then dropped, and
    an equal-power crossfade of ``crossfade`` samples over each seam. The
    decode uses the request's random streams as ``Synthesizer.infer`` does
    and carries one dropout generator across segments, so the decoder mel is
    that of ``infer`` for the same seed, whatever the chunk size. The audio
    is not bit-equal to offline synthesis at chunk seams: the postnet and
    the vocoder see windows, and WaveGlow draws its z per window.
    """

    def __init__(self, hp, model=None, waveglow=None, chunk: int = 40,
                 lookback: int = 16, sigma: float = 0.666,
                 crossfade: int = 128, griffin_lim_iters: int = 30,
                 device="cuda", seed: int = 0):
        if waveglow is None and lookback < 1:
            # Griffin-Lim's ISTFT yields (T-1)*hop samples per window, so a
            # zero-lookback window is hop samples short of the chunk and
            # the emitted chunks would no longer tile the waveform.
            raise ValueError("Griffin-Lim streaming needs lookback >= 1")
        super().__init__(hp, model, device, seed)
        self.waveglow = waveglow
        self.chunk, self.lookback = chunk, lookback
        self.sigma = sigma
        self.crossfade = crossfade
        self.griffin_lim_iters = griffin_lim_iters

    def _vocode(self, mel_win, z_generator):
        if self.waveglow is not None:
            return self.waveglow.infer(mel_win, self.sigma, z_generator)
        return mel_to_wav_griffin_lim(mel_win, self.mel_fn,
                                      n_iters=self.griffin_lim_iters,
                                      generator=z_generator)

    @torch.no_grad()
    def stream(self, text, seed: int = 0, max_steps: Optional[int] = None,
               style=None, emotions=None, speaker=None, text_lengths=None):
        """Generator over (B, samples) float32 numpy wav chunks, each yielded
        as soon as its audio is on the host. ``text``: str or (B, T) ids;
        ``style``/``emotions``/``speaker``/``text_lengths`` as in
        ``Synthesizer.infer``. After exhaustion ``last_lengths`` holds each
        sample's valid frames (at most the cap) and ``last_mel`` the decoder
        mel (B, n_mel, frames streamed), before the postnet."""
        hp, model = self.hp, self.model
        ids, lengths = self._ids(text, text_lengths)
        lens = torch.from_numpy(lengths).to(self.device)
        cap = max_steps or hp.max_decoder_steps
        K, hop, lb = hp.n_frames_per_step, hp.hop_length, self.lookback
        memory = model.encode_memory(
            torch.from_numpy(ids).to(self.device), style, emotions, speaker,
            text_lengths=lens, noise_generator=generator(
                self.device, _stream_seed(seed, _NOISE)))
        dec_gen = generator(self.device, _stream_seed(seed, _DROPOUT))
        voc_device = (self.waveglow.device if self.waveglow is not None
                      else self.device)
        z_gen = generator(voc_device, _stream_seed(seed, _Z))
        inputs = model.decoder.open_loop_inputs(memory, lens)
        carry = model.decoder.infer_init(memory, cap)
        B = ids.shape[0]
        tail = memory.new_zeros(B, hp.n_mel_channels, lb)
        held = None  # the last xf samples, held back for the seam blend
        steps = 0
        xf = min(self.crossfade, lb * hop)
        segments = []
        self.last_lengths = np.full((B,), cap * K, np.int64)
        while steps < cap:
            # The last segment stops at the cap, also where the cap is no
            # chunk multiple: no audio past it.
            n = min(self.chunk, cap - steps)
            carry, mel_seg, _, _, seg_lengths, finished = \
                model.decoder.infer_segment(memory, carry, dec_gen, n, inputs)
            segments.append(mel_seg)
            window = torch.cat([tail, mel_seg], dim=2)
            wav_win = self._vocode(model.postnet_residual(window), z_gen)
            # Not `window[..., -lb:]`: at lb = 0 that is the whole window.
            tail = window[:, :, window.shape[2] - lb:]
            # One host sync a chunk: the window's audio, lengths and stop.
            wav_win = wav_win.cpu().numpy()
            lengths_h = seg_lengths.cpu().numpy()
            finished_h = bool(finished)
            # Griffin-Lim's ISTFT yields (T-1)*hop samples a window, WaveGlow
            # T*hop: shift the kept region so the chunks tile the waveform.
            shift = max((lb + n * K) * hop - wav_win.shape[1], 0)
            start = max(lb * hop - shift, 0)
            # Frames past a sample's stop are zero log-mels, which vocode as
            # loud noise: silence them, per sample, to the window's end.
            for b in range(B):
                cut = start + (int(lengths_h[b]) - steps * K) * hop
                wav_win[b, max(min(cut, wav_win.shape[1]), 0):] = 0.0
            wav = wav_win[:, start: start + n * K * hop]
            steps += n
            self.last_lengths = np.minimum(lengths_h, cap * K)
            xf = min(xf, start)
            if held is not None and xf:
                # This window's lookback re-synthesizes the held samples:
                # blend toward the new version across the seam.
                t = np.linspace(0.0, 1.0, xf, dtype=np.float32)
                redo = wav_win[:, start - xf: start]
                held = held * np.sqrt(1.0 - t) + redo * np.sqrt(t)
                wav = np.concatenate([held, wav], axis=1)
            if xf:
                held = wav[:, -xf:]
                wav = wav[:, :-xf]
            yield wav
            if finished_h:
                break
        self.last_mel = torch.cat(segments, dim=2)
        if held is not None and xf:
            yield held

    def synthesize(self, text, seed: int = 0, max_steps: Optional[int] = None,
                   style=None, emotions=None, speaker=None,
                   text_lengths=None):
        """Collects the stream. Returns (wav (B, samples) trimmed to the
        longest decoded length, lengths (B,) in frames, time to first audio
        in seconds, total seconds), both times read after the card has
        finished the work they cover."""
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        ttfa, chunks = None, []
        for chunk in self.stream(text, seed, max_steps, style, emotions,
                                 speaker, text_lengths):
            if ttfa is None:
                sync()
                ttfa = time.perf_counter() - t0
            chunks.append(chunk)
        sync()
        total = time.perf_counter() - t0
        wav = np.concatenate(chunks, axis=1)
        lengths = self.last_lengths
        return wav[:, :int(lengths.max()) * self.hp.hop_length], lengths, \
            ttfa, total
