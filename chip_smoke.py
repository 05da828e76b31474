#!/usr/bin/env python3
"""Drives the PyTorch port (gantron_tpu_torch) on one CUDA card and checks it.

    python3 chip_smoke.py [--out DIR]   # from the repository root, with a card

Phases, in order; any failed check raises and the script exits non-zero:

1. Device and build: prints the card and its power limit, builds both CUDA
   kernels (csrc/qmm.cu, csrc/mel.cu) with nvcc (sm_90a) in one call and
   prints the build time and each kernel's ptxas report.
2. qmm against its plain version: the qmm kernel on the decoder's four
   recurrence-matrix shapes at full width, B in {1, 8, 32}, float32 and
   bfloat16, plus ragged shapes; then times one decoder step's four products
   (kernel, plain version, a dense-matmul yardstick), as device time
   (CUDA-graph replay) and, for the kernel, as issued eagerly.
3. mel against its plain version: the mel kernel on reflect-padded waveforms
   (B=8 x 10 s, B=1 x 501 frames, 20 frames, a 300-sample wave, B=32 x 2 s)
   at atol 2e-3, TF32 off, and a second launch on the same input bit-equal
   to the first; then times it at B=8 x 10 s and B=1 x 501 frames beside
   the plain version, a torch.stft (cuFFT) yardstick and the bound (a real
   FFT's operations or the bytes, whichever takes longer).
4. Slice parity: the full-width decoder (int8 recurrence matrices, prenet
   dropout off, injected style) for 50 steps on the card against the same
   model on the CPU.
5. Serving path: ``Synthesizer`` at HParams defaults plus use_noise,
   no labels and quantized_inference, text -> mel (early exit, cap 500
   steps) -> WaveGlow -> waveform, on one sentence and on a ragged batch of
   8. The qmm launch count must be 4 x the decoder steps run.
6. Trace: a torch.profiler trace of 50 decoder steps at B=1, read for the
   device's busy share and the kernel time by name (written to DIR,
   default chip_smoke_out/).
7. Data path: a 32-utterance tone corpus (1.4-9.7 s, written to a temporary
   directory) through ``TextMelDataset(device="cuda")`` with its mel cache,
   ``DataLoader`` and ``PrefetchLoader``: one mel launch per utterance, mels
   equal to ``device="cpu"`` within atol 2e-3, T_out a multiple of
   lcm(discriminator_window, K); audio seconds featurized per second on the
   card and on the host CPU.
8. Round trip: ``MelSpectrogram`` on the card over phase 5's B=8 WaveGlow
   waveforms: one launch, finite, the waveform's frame count.
9. Griffin-Lim serving: ``Synthesizer.tts`` without a WaveGlow (500 steps,
   30 iterations): a finite waveform of (L - 1) * hop samples; time and RTF.

Before the last line it prints one JSON line ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``. Weights are random, drawn from
fixed seeds; no checkpoint is read.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

RTF_TEXT = ("This voice was generated by a machine, measuring end to end "
            "synthesis speed.")
BATCH_TEXTS = [
    RTF_TEXT,
    "Printing, in the only sense with which we are at present concerned.",
    "The quick brown fox jumps over the lazy dog.",
    "He paid $3.50 for 2 cups of tea on Jan. 1st.",
    "Dr. Smith will see you now.",
    "In being comparatively modern.",
    "It was a bright cold day in April, and the clocks were striking "
    "thirteen.",
    "Yes.",
]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),   # sum order differs
       torch.bfloat16: dict(rtol=1e-2, atol=1e-6)}  # one bf16 ulp of y
# log-mel: near the 1e-5 clip floor the log turns tiny spectrum differences
# into large ones (tests/test_pallas_mel.py uses the same tolerance).
MEL_ATOL = 2e-3
MEL_SHAPES = [(8, 220500), (1, 128000), (1, 5000), (1, 300), (32, 44100)]


def log(msg):
    print(msg, flush=True)


def _events_ms(run, calls):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def eager_ms(fn, iters=50):
    """Time of one ``fn()`` in ms as a caller issues it: CUDA events around
    ``iters`` back-to-back calls after a warm-up. Where the host issues
    slower than the card runs, this is the host's time per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return _events_ms(lambda: [fn() for _ in range(iters)], iters)


def device_ms(fn, iters=50, reps=5):
    """Device time of one ``fn()`` in ms, without the host's launch cost:
    ``iters`` calls captured in one CUDA graph, replayed between CUDA
    events; the mean of ``reps`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = [_events_ms(graph.replay, iters) for _ in range(reps)]
    return sum(times) / reps


def qmm_bound(shapes, dtype):
    """(ms, "bytes" | "operations"): the least time for these products. Bytes:
    q, scale, x and y once each; operations: 2*B*I*O at x's type's peak."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = sum(I * O + 4 * O + B * I * es + B * O * es for B, I, O in shapes)
    ops = sum(2 * B * I * O for B, I, O in shapes)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from gantron_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.build("qmm", "mel")
    log(f"[build] csrc/qmm.cu and csrc/mel.cu built in "
        f"{time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for name in ("qmm", "mel"):
        for line in cuda_build.build_log.get(name, {}).get("ptxas", "") \
                .splitlines():
            if any(k in line for k in ("registers", "spill",
                                       "Compiling entry")):
                log(f"[build] {name}: {line.strip()}")


def main_path_matrices(hp):
    """The four int8 recurrence matrices that the serving path's decoder
    multiplies on every step (attention-LSTM context rows and hidden,
    decoder-LSTM input and hidden), at full width, on the card."""
    from gantron_tpu_torch.models.tacotron2 import Tacotron2

    W = Tacotron2(hp, device="cuda", seed=0).decoder._scan_weights(
        quantize=True)
    return [W.wc, W.wh1, W.w2ih, W.w2hh]


def phase_kernel(hp):
    from gantron_tpu_torch.ops.quant import (dequantize, qmatmul, qmm,
                                             quantize_per_channel)

    dev = torch.device("cuda")
    mats = main_path_matrices(hp)
    rng = np.random.RandomState(1)
    checks, max_err = [], 0.0

    def check(B, qm, dtype, main_path):
        nonlocal max_err
        I, O = qm.q.shape
        x = torch.from_numpy(rng.normal(0, 1, (B, I)).astype(np.float32)) \
            .to(dev, dtype)
        y = qmm(x, qm)
        torch.cuda.synchronize()
        ref = qmatmul(x, qm)
        err = (y.float() - ref.float()).abs().max().item()
        ok = torch.allclose(y.float(), ref.float(), **TOL[dtype])
        checks.append({"B": B, "I": I, "O": O, "dtype": str(dtype)[6:],
                       "max_abs_err": err, "tol": TOL[dtype], "ok": ok})
        log(f"[kernel] B={B:<3d} I={I:<5d} O={O:<5d} {str(dtype)[6:]:9s} "
            f"max|kernel - plain| = {err:.3e}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"qmm disagrees with its plain version at "
                                 f"B={B}, I={I}, O={O}, {dtype}")
        if main_path and dtype == torch.float32:
            max_err = max(max_err, err)

    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 8, 32):
            for qm in mats:
                check(B, qm, dtype, True)
    for B, I, O in ((3, 200, 300), (5, 77, 301)):  # 301: no 4-byte loads
        w = torch.from_numpy(rng.normal(0, 0.05, (I, O)).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            check(B, quantize_per_channel(w.to(dev)), dtype, False)

    # Timing: one decoder step's four products, cycling through all four
    # matrices (21 MB of int8, resident in the 50 MB L2 as in decode).
    timings = {}
    for B in (1, 8):
        xs = [torch.from_numpy(rng.normal(0, 1, (B, qm.q.shape[0]))
                               .astype(np.float32)).to(dev) for qm in mats]
        w_deq = [dequantize(qm, torch.float32) for qm in mats]
        pairs = list(zip(xs, mats))
        shapes = [(B, qm.q.shape[0], qm.q.shape[1]) for qm in mats]
        bound_ms, bound_by = qmm_bound(shapes, torch.float32)
        step_qmm = lambda: [qmm(x, qm) for x, qm in pairs]  # noqa: E731
        t = {"ms": device_ms(step_qmm),
             "eager_ms": eager_ms(step_qmm),
             "plain_ms": device_ms(
                 lambda: [qmatmul(x, qm) for x, qm in pairs]),
             "library_ms": device_ms(
                 lambda: [x @ w for x, w in zip(xs, w_deq)]),
             "bound_ms": bound_ms, "bound_by": bound_by,
             "shapes": shapes, "per_matrix": []}
        for (x, qm), w, shape in zip(pairs, w_deq, shapes):
            b_ms, b_by = qmm_bound([shape], torch.float32)
            t["per_matrix"].append({
                "B": shape[0], "I": shape[1], "O": shape[2],
                "ms": device_ms(lambda: qmm(x, qm), 200),
                "eager_ms": eager_ms(lambda: qmm(x, qm), 200),
                "plain_ms": device_ms(lambda: qmatmul(x, qm), 200),
                "library_ms": device_ms(lambda: x @ w, 200),
                "bound_ms": b_ms, "bound_by": b_by})
        timings[B] = t
        log(f"[kernel] one decoder step (4 products), B={B}, float32, "
            f"device time: kernel {t['ms'] * 1e3:.2f} us, plain "
            f"{t['plain_ms'] * 1e3:.2f} us, x @ w_deq "
            f"{t['library_ms'] * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
            f"({bound_by}); issued eagerly: kernel {t['eager_ms'] * 1e3:.2f}"
            " us")
        for m in t["per_matrix"]:
            log(f"[kernel]   ({m['B']}, {m['I']}) @ ({m['I']}, {m['O']}): "
                f"kernel {m['ms'] * 1e3:.2f} us (eager "
                f"{m['eager_ms'] * 1e3:.2f} us), plain "
                f"{m['plain_ms'] * 1e3:.2f} us, x @ w_deq "
                f"{m['library_ms'] * 1e3:.2f} us, bound "
                f"{m['bound_ms'] * 1e3:.2f} us")
    return {"checks": checks, "max_abs_err": max_err, "timings": timings}


def mel_bound(B, S, T, n_fft, n_bins, n_mel, nnz):
    """(ms, "bytes" | "operations", dense_dft_ms): the least time for
    ``log_mel`` on a (B, S) padded waveform, from the least work the function
    needs. Operations a frame: a real FFT (2.5*n_fft*log2(n_fft), the
    radix-2 count), the magnitudes (3 a bin) and the filterbank's ``nnz``
    nonzeros (2 each), at the float32 peak; bytes: the waveform, the window,
    the filterbank and the output once each. ``dense_dft_ms`` is the time of
    the kernel's own way of doing it, the dense DFT and mel products
    (2*n_fft*2*n_bins + 2*n_bins*n_mel a frame), at the same peak."""
    frames = B * T
    ops = frames * (2.5 * n_fft * math.log2(n_fft) + 3 * n_bins + 2 * nnz)
    nbytes = 4 * (B * S + n_fft + n_bins * n_mel + B * n_mel * T)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[torch.float32]
    dense = frames * (2 * n_fft * 2 * n_bins + 2 * n_bins * n_mel)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            dense / PEAK_OPS_PER_S[torch.float32] * 1e3)


def phase_mel_kernel(hp):
    """The mel kernel against its plain version at the shapes the audio
    paths give it, then timed beside the plain version and a cuFFT
    yardstick (timed only: the port never calls torch.stft)."""
    from gantron_tpu_torch.audio.mel import MelSpectrogram
    from gantron_tpu_torch.ops.mel import log_mel, log_mel_plain, reflect_pad

    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default
    mel_fn = MelSpectrogram(hp.filter_length, hp.hop_length, hp.win_length,
                            hp.n_mel_channels, hp.sampling_rate, hp.mel_fmin,
                            hp.mel_fmax, device="cuda")
    consts, n_fft = mel_fn.consts, hp.filter_length
    n_bins, n_mel = consts.mel_w.shape
    nnz = int(torch.count_nonzero(consts.mel_w))
    window = torch.hann_window(hp.win_length, periodic=True, device="cuda")
    rng = np.random.RandomState(4)
    checks, max_err, timings = [], 0.0, {}
    for B, N in MEL_SHAPES:
        y = torch.from_numpy(np.clip(rng.normal(0, 0.2, (B, N)), -1, 1)
                             .astype(np.float32)).cuda()
        yp = reflect_pad(y, n_fft // 2)
        out = log_mel(yp, consts)
        repeat_equal = bool(torch.equal(out, log_mel(yp, consts)))
        torch.cuda.synchronize()
        ref = log_mel_plain(yp, consts)
        err = (out - ref).abs().max().item()
        T = mel_fn.n_frames(N)
        ok = out.shape == (B, n_mel, T) and err <= MEL_ATOL \
            and bool(torch.isfinite(out).all()) and repeat_equal
        checks.append({"B": B, "samples": N, "frames": T,
                       "max_abs_err": err, "atol": MEL_ATOL,
                       "repeat_bit_equal": repeat_equal, "ok": ok})
        log(f"[mel] B={B:<3d} {N:>6d} samples ({T:>3d} frames): "
            f"max|kernel - plain| = {err:.3e}, a second launch bit-equal: "
            f"{repeat_equal}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"mel kernel disagrees with its plain "
                                 f"version at B={B}, {N} samples")
        max_err = max(max_err, err)
        if (B, N) not in ((8, 220500), (1, 128000)):
            continue

        def library(y=y):
            spec = torch.stft(y, n_fft, hp.hop_length, hp.win_length, window,
                              center=True, pad_mode="reflect",
                              return_complex=True)
            return torch.log(torch.clamp(mel_fn.mel_basis @ spec.abs(),
                                         min=1e-5))

        bound_ms, bound_by, dense_ms = mel_bound(B, yp.shape[1], T, n_fft,
                                                 n_bins, n_mel, nnz)
        t = {"B": B, "samples": N, "frames": T,
             "ms": device_ms(lambda: log_mel(yp, consts), 20),
             "eager_ms": eager_ms(lambda: log_mel(yp, consts), 20),
             "plain_ms": device_ms(lambda: log_mel_plain(yp, consts), 20),
             "library_ms": device_ms(library, 20),
             "library_max_abs_err": (library() - out).abs().max().item(),
             "call_eager_ms": eager_ms(lambda: mel_fn(y), 20),
             "bound_ms": bound_ms, "bound_by": bound_by,
             "dense_dft_bound_ms": dense_ms}
        timings[f"B={B}x{N}"] = t
        log(f"[mel] B={B} x {N} samples, device time: kernel "
            f"{t['ms'] * 1e3:.1f} us, plain {t['plain_ms'] * 1e3:.1f} us, "
            f"torch.stft + mel {t['library_ms'] * 1e3:.1f} us (max|stft - "
            f"kernel| {t['library_max_abs_err']:.2e}), bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by}; the dense DFT's "
            f"operations alone {dense_ms * 1e3:.1f} us); issued eagerly: "
            f"kernel {t['eager_ms'] * 1e3:.1f} us, MelSpectrogram call "
            f"{t['call_eager_ms'] * 1e3:.1f} us")
    return {"checks": checks, "max_abs_err": max_err, "timings": timings}


def phase_parity(hp, steps=50):
    """Full-width decode on the card against the port on the CPU."""
    from gantron_tpu_torch.models.tacotron2 import Tacotron2
    from gantron_tpu_torch.text import text_to_sequence

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ids = torch.tensor([text_to_sequence(RTF_TEXT, hp.text_cleaners)])
    style = torch.from_numpy(np.random.RandomState(2).rand(
        1, 1, hp.noise_size).astype(np.float32))
    outs = {}
    for device in ("cpu", "cuda"):
        model = Tacotron2(hp, device=device, seed=0)
        model.decoder.prenet_dropout = False
        t0 = time.perf_counter()
        out = model.infer(ids, style, max_steps=steps)
        outs[device] = [o.cpu() for o in out]
        log(f"[parity] {device}: {steps} steps in "
            f"{time.perf_counter() - t0:.2f} s")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default again
    cpu, gpu = outs["cpu"], outs["cuda"]
    tol = 1e-3  # float32 sum order, carried through 50 autoregressive steps
    for name, i in (("mel", 0), ("mel_postnet", 1), ("gate", 2)):
        err = (gpu[i] - cpu[i]).abs().max().item()
        log(f"[parity] max|card - cpu| {name} = {err:.3e} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"card and CPU decodes differ in {name}")
    # A stop decision may flip only where the gate sits at the threshold.
    thr = float(np.log(hp.gate_threshold / (1 - hp.gate_threshold)))
    for b, (lc, lg) in enumerate(zip(cpu[4].tolist(), gpu[4].tolist())):
        step = min(lc, lg) - 1
        if lc != lg and abs(cpu[2][b, step].item() - thr) > tol:
            raise AssertionError(f"lengths differ: cpu {lc}, card {lg}")
    log(f"[parity] lengths cpu {cpu[4].tolist()} card {gpu[4].tolist()}")


def pad_ids(texts, cleaners):
    from gantron_tpu_torch.text import text_to_sequence

    seqs = [text_to_sequence(t, cleaners) for t in texts]
    ids = np.zeros((len(seqs), max(map(len, seqs))), np.int64)
    for b, s in enumerate(seqs):
        ids[b, :len(s)] = s
    return ids


def phase_serving(hp, gpu):
    from gantron_tpu_torch.models.waveglow import (WaveGlow, WaveGlowConfig,
                                                   random_params)
    from gantron_tpu_torch.ops.quant import qmm
    from gantron_tpu_torch.tts import Synthesizer

    K, hop, sr = hp.n_frames_per_step, hp.hop_length, hp.sampling_rate
    synth = Synthesizer(hp, device="cuda", seed=0)
    cfg = WaveGlowConfig()
    waveglow = WaveGlow(cfg, random_params(torch.Generator().manual_seed(3),
                                           cfg), device="cuda")
    results, wavs = {}, {}
    qmm.launches = 0  # the main path starts here
    for label, texts in (("B=1", [RTF_TEXT]), ("B=8", BATCH_TEXTS)):
        for run in range(2):  # the first run includes cuDNN's warm-up
            torch.cuda.synchronize()
            before = qmm.launches
            t0 = time.perf_counter()
            if len(texts) == 1:
                mel, L = synth.infer_mel(texts[0], seed=run)
                pairs = [(mel, L)]
            else:
                pairs = synth.infer_mel(pad_ids(texts, hp.text_cleaners),
                                        seed=run)
            torch.cuda.synchronize()
            t_dec = time.perf_counter() - t0
            launches = qmm.launches - before
            lengths = [L for _, L in pairs]
            steps = max(lengths) // K
            if launches != 4 * steps:
                raise AssertionError(f"{label}: {launches} qmm launches for "
                                     f"{steps} decoder steps")
            Lmax = max(lengths)
            mels = torch.zeros(len(pairs), hp.n_mel_channels, Lmax,
                               device="cuda")
            for b, (m, L) in enumerate(pairs):
                mels[b, :, :L] = m
            t0 = time.perf_counter()
            wav = waveglow.infer(mels, 0.666, torch.Generator(
                device="cuda").manual_seed(run))
            torch.cuda.synchronize()
            t_wg = time.perf_counter() - t0
            if wav.shape != (len(pairs), Lmax * hop) or \
                    not torch.isfinite(wav).all():
                raise AssertionError(f"{label}: waveform {tuple(wav.shape)} "
                                     "is not finite or of the decoded length")
            wavs[label] = wav
            audio_s = sum(lengths) * hop / sr
            results[label] = {
                "decode_s": t_dec, "waveglow_s": t_wg, "audio_s": audio_s,
                "rtf": (t_dec + t_wg) / (lengths[0] * hop / sr),
                "audio_s_per_s": audio_s / (t_dec + t_wg),
                "decoder_steps": steps, "qmm_launches": launches,
                "lengths": lengths}
            log(f"[serve] {label} run {run}: decode {t_dec:.3f} s "
                f"({steps} steps, {launches} qmm launches), WaveGlow "
                f"{t_wg:.3f} s, audio {audio_s:.3f} s, RTF "
                f"{results[label]['rtf']:.4f}, "
                f"{results[label]['audio_s_per_s']:.2f} audio s/s, lengths "
                f"{lengths} [{gpu}]")
    wav = synth.tts(RTF_TEXT, waveglow, seed=5)
    L = synth.infer_mel(RTF_TEXT, seed=5)[1]
    if wav.shape != (L * hop,) or not np.isfinite(wav).all():
        raise AssertionError("tts() waveform is not finite or of the "
                             "decoded length")
    total_launches = qmm.launches  # read just after the main path
    return results, total_launches, synth, wavs["B=8"]


def phase_trace(synth, hp, out_dir, steps=50):
    """Where a B=1 decode step's time goes: a ``torch.profiler`` trace of
    ``steps`` decoder steps (the encoder runs before it), read for the
    device's busy time (the union of kernel intervals) and the kernel time by
    name."""
    from torch.profiler import ProfilerActivity, profile

    from gantron_tpu_torch.text import text_to_sequence

    ids = torch.tensor([text_to_sequence(RTF_TEXT, hp.text_cleaners)])
    memory = synth.model.encode_memory(
        ids, noise_generator=torch.Generator(device="cuda").manual_seed(1))

    def decode():
        synth.model.decoder.infer(
            memory, torch.Generator(device="cuda").manual_seed(0),
            max_steps=steps)
        torch.cuda.synchronize()

    decode()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "decode_b1_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not kernels:
        log("[trace] the profiler recorded no kernels: device busy share "
            "not measured")
        return None
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events))
    busy, end = 0.0, -1.0
    for e in sorted(kernels, key=lambda e: e["ts"]):
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    by_name = {}
    for e in kernels:
        n, d = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, d + e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    result = {
        "steps": steps, "span_us": span, "device_busy_us": busy,
        "busy_share_under_profiler": busy / span,
        "kernel_launches": len(kernels),
        "top_kernels": [{"name": n[:80], "count": c, "total_us": d}
                        for n, (c, d) in top]}
    log(f"[trace] B=1, {steps} decoder steps under the profiler: span "
        f"{span / 1e3:.2f} ms, device busy {busy / 1e3:.3f} ms "
        f"({100 * busy / span:.1f}%), {len(kernels)} kernels "
        f"({len(kernels) / steps:.1f} a step); trace in {path}")
    for item in result["top_kernels"]:
        log(f"[trace]   {item['total_us'] / steps:8.2f} us/step "
            f"{item['count'] / steps:5.1f}/step  {item['name']}")
    return result


def phase_data(hp):
    """The wav -> mel corpus path at LJSpeech-like utterance lengths, on the
    card through the loader a trainer uses, then on the host CPU."""
    from gantron_tpu_torch.data import toy
    from gantron_tpu_torch.data.dataset import (DataLoader, PrefetchLoader,
                                                TextMelDataset, collate)
    from gantron_tpu_torch.data.wav import load_wav
    from gantron_tpu_torch.ops.mel import log_mel
    from gantron_tpu_torch.ops.quant import qmm

    n_utts, B = 32, 8
    W = math.lcm(hp.discriminator_window, max(hp.n_frames_per_step, 1))
    with tempfile.TemporaryDirectory() as root:
        wav_dir, train_list, _ = toy.build_corpus(
            root, n_utts=n_utts, n_train=n_utts, min_chars=20,
            max_chars=141, seed=0)
        datasets = {dev: TextMelDataset([train_list], hp, wav_dir,
                                        os.path.join(root, f"cache_{dev}"),
                                        device=dev)
                    for dev in ("cuda", "cpu")}
        paths = [e[0] for e in datasets["cuda"].entries]
        wavs = [load_wav(p, hp.sampling_rate) for p in paths]
        audio_s = sum(len(w) for w in wavs) / hp.sampling_rate

        torch.cuda.synchronize()
        log_mel.launches = qmm.launches = 0  # the data path starts here
        t0 = time.perf_counter()
        batches = list(PrefetchLoader(DataLoader(datasets["cuda"], hp,
                                                 batch_size=B)))
        t_card = time.perf_counter() - t0
        launches = log_mel.launches  # read just after the data path
        if launches != n_utts or len(batches) != n_utts // B:
            raise AssertionError(f"data path: {launches} mel launches and "
                                 f"{len(batches)} batches for {n_utts} "
                                 "utterances")
        for batch in batches + [collate([datasets["cuda"][i]
                                         for i in range(B)], hp)]:
            T_out = batch.mels.shape[2]
            if T_out % W or T_out < batch.output_lengths.max():
                raise AssertionError(f"collate: T_out {T_out} is no "
                                     f"multiple of {W} or cuts a mel")
        t0 = time.perf_counter()
        cpu_mels = [datasets["cpu"].get_mel(p) for p in paths]
        t_cpu = time.perf_counter() - t0
        err = max(np.abs(datasets["cuda"].get_mel(p) - m).max()
                  for p, m in zip(paths, cpu_mels))  # the card's, cached
        if not err <= MEL_ATOL:
            raise AssertionError(f"data path: card and CPU mels differ by "
                                 f"{err}")
        # Featurizing alone (wavs in memory, no cache): one call per wav.
        feat = {}
        for dev in ("cuda", "cpu"):
            mel_fn = datasets[dev].mel_fn
            mel_fn(wavs[0][None]).cpu()  # warm-up
            t0 = time.perf_counter()
            for w in wavs:
                mel_fn(w[None]).cpu()
            feat[dev] = audio_s / (time.perf_counter() - t0)
    result = {
        "utterances": n_utts, "audio_s": audio_s, "mel_launches": launches,
        "batches": len(batches), "max_abs_err_card_vs_cpu": float(err),
        "loader_s": t_card, "loader_audio_s_per_s": audio_s / t_card,
        "cpu_dataset_s": t_cpu, "cpu_dataset_audio_s_per_s": audio_s / t_cpu,
        "featurize_audio_s_per_s": feat,
        "T_out": [int(b.mels.shape[2]) for b in batches]}
    log(f"[data] {n_utts} utterances, {audio_s:.1f} s of audio: "
        f"PrefetchLoader(DataLoader) on the card {t_card:.3f} s "
        f"({audio_s / t_card:.1f} audio s/s, {launches} mel launches, "
        f"T_out {result['T_out']}); TextMelDataset on the CPU {t_cpu:.3f} s "
        f"({audio_s / t_cpu:.1f} audio s/s); max|card - cpu| {err:.2e}; "
        f"featurizing alone: card {feat['cuda']:.1f}, CPU "
        f"{feat['cpu']:.1f} audio s/s")
    return result


def phase_roundtrip(hp, wav):
    """The WaveGlow output of the serving phase back to a mel on the card."""
    from gantron_tpu_torch.audio.mel import MelSpectrogram
    from gantron_tpu_torch.ops.mel import log_mel
    from gantron_tpu_torch.ops.quant import qmm

    mel_fn = MelSpectrogram(hp.filter_length, hp.hop_length, hp.win_length,
                            hp.n_mel_channels, hp.sampling_rate, hp.mel_fmin,
                            hp.mel_fmax, device="cuda")
    torch.cuda.synchronize()
    log_mel.launches = qmm.launches = 0  # the round trip starts here
    mel = mel_fn(wav)
    torch.cuda.synchronize()
    launches = log_mel.launches
    shape = (wav.shape[0], hp.n_mel_channels, mel_fn.n_frames(wav.shape[1]))
    if launches != 1 or tuple(mel.shape) != shape \
            or not torch.isfinite(mel).all():
        raise AssertionError(f"round trip: {launches} launches, mel "
                             f"{tuple(mel.shape)} (expected {shape})")
    log(f"[roundtrip] WaveGlow waveforms {tuple(wav.shape)} -> mel "
        f"{tuple(mel.shape)} in {launches} launch")
    return {"launches": launches, "wav_shape": list(wav.shape),
            "mel_shape": list(mel.shape)}


def phase_griffin_lim(synth, hp, gpu):
    """Vocoder-free serving: text -> mel -> 30 Griffin-Lim iterations."""
    from gantron_tpu_torch.audio.mel import mel_to_wav_griffin_lim
    from gantron_tpu_torch.ops.mel import log_mel
    from gantron_tpu_torch.ops.quant import qmm

    hop, sr, iters = hp.hop_length, hp.sampling_rate, 30
    runs = []
    for run in range(2):  # the first run includes the warm-up
        torch.cuda.synchronize()
        log_mel.launches = qmm.launches = 0  # the Griffin-Lim path starts
        t0 = time.perf_counter()
        wav = synth.tts(RTF_TEXT, seed=7, griffin_lim_iters=iters)
        t_tts = time.perf_counter() - t0
        runs.append({"tts_s": t_tts, "qmm_launches": qmm.launches,
                     "mel_launches": log_mel.launches})
    mel, L = synth.infer_mel(RTF_TEXT, seed=7)
    min_frames = hp.filter_length // hop + 1
    expected = min(L, max(L, min_frames) - 1) * hop
    if wav.shape != (expected,) or not np.isfinite(wav).all():
        raise AssertionError(f"Griffin-Lim tts(): waveform {wav.shape}, "
                             f"expected ({expected},) finite samples")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    mel_to_wav_griffin_lim(mel[None], synth.mel_fn, n_iters=iters,
                           generator=gen)
    torch.cuda.synchronize()
    t_gl = time.perf_counter() - t0
    audio_s = len(wav) / sr
    result = {"frames": L, "samples": len(wav), "audio_s": audio_s,
              "iterations": iters, "runs": runs,
              "griffin_lim_s": t_gl, "rtf": runs[-1]["tts_s"] / audio_s,
              "griffin_lim_rtf": t_gl / audio_s}
    log(f"[griffin-lim] tts() without WaveGlow: {L} frames -> {len(wav)} "
        f"samples ({audio_s:.3f} s), {runs[-1]['tts_s']:.3f} s end to end "
        f"(first run {runs[0]['tts_s']:.3f} s), RTF {result['rtf']:.4f}; "
        f"{iters} Griffin-Lim iterations alone {t_gl:.3f} s (RTF "
        f"{result['griffin_lim_rtf']:.4f}), qmm launches "
        f"{runs[-1]['qmm_launches']} [{gpu}]")
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chip_smoke_out",
                        help="directory for the profiler trace")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gantron_tpu_torch.config import HParams

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s): {kind}")
    log(smi)

    phase_build()
    hp = HParams.create(
        "use_noise=True,use_labels=False,quantized_inference=True")
    kernel = phase_kernel(hp)
    mel = phase_mel_kernel(hp)
    phase_parity(hp)
    serving, launches, synth, wav_b8 = phase_serving(hp, smi)
    trace = phase_trace(synth, hp, args.out)
    data = phase_data(hp)
    roundtrip = phase_roundtrip(hp, wav_b8)
    griffin_lim = phase_griffin_lim(synth, hp, smi)

    t = kernel["timings"][1]
    qmm_entry = {
        "name": "qmm", "route": "cuda",
        "source": "gantron_tpu_torch/csrc/qmm.cu",
        "replaces": "gantron_tpu/ops/quant.py:99",
        "launches": launches, "max_abs_err": kernel["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "kernel_ms": t["ms"], "tol": TOL[torch.float32],
        "timed": "one decoder step's four products at B=1, float32",
        "shapes": t["shapes"], "timings_by_batch": kernel["timings"],
        "checks": kernel["checks"], "serving": serving, "trace": trace,
        "griffin_lim": griffin_lim, "gpu": smi,
    }
    t = mel["timings"]["B=8x220500"]
    mel_entry = {
        "name": "mel", "route": "cuda",
        "source": "gantron_tpu_torch/csrc/mel.cu",
        "replaces": "gantron_tpu/ops/pallas_mel.py:62",
        "launches": data["mel_launches"], "max_abs_err": mel["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "dense_dft_bound_ms": t["dense_dft_bound_ms"],
        "tol": {"atol": MEL_ATOL},
        "timed": "B=8 x 220500 samples (862 frames each), float32",
        "shapes": [[B, N] for B, N in MEL_SHAPES],
        "timings_by_shape": mel["timings"], "checks": mel["checks"],
        "data_path": data, "roundtrip": roundtrip, "gpu": smi,
    }
    print(json.dumps({"kernels": [qmm_entry, mel_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
