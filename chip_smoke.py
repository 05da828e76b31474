#!/usr/bin/env python3
"""Drives the PyTorch port (gantron_tpu_torch) on one CUDA card and checks it.

    python3 chip_smoke.py [--out DIR]   # from the repository root, with a card

Phases, in order; any failed check raises and the script exits non-zero:

1. Device and build: prints the card and its power limit, builds both CUDA
   kernels (csrc/qmm.cu, csrc/mel.cu) with nvcc (sm_90a) in one call and
   prints the build time and each kernel's ptxas report.
2. qmm against its plain version: the qmm kernel on the decoder's four
   recurrence-matrix shapes at full width, B in {1, 8, 32}, float32 and
   bfloat16, plus ragged shapes, and a second launch on the same input
   bit-equal to the first; then times one decoder step's four products at
   B in {1, 8, 32} (kernel, plain version, a dense-matmul yardstick), as
   device time (CUDA-graph replay) and, for the kernel, as issued eagerly.
3. mel against its plain version: the mel kernel's FFT route on
   reflect-padded waveforms (B=8 x 10 s, B=1 x 501 frames, 20 frames, a
   300-sample wave, B=32 x 2 s) at atol 2e-3, TF32 off, and a second launch
   on the same input bit-equal to the first; the same checks for a second
   power of two (16 kHz, n_fft 512, 40 mels) and for the dense route
   (n_fft 800); then times the default featurizer at B=8 x 10 s and B=1 x
   501 frames beside the plain version, a torch.stft (cuFFT) yardstick and
   the bound (a real FFT's operations or the bytes, whichever takes longer).
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
10. Streaming serving: ``StreamingSynthesizer`` (chunk 40, int8 decoder) on
    phase 5's sentence and batch of 8, with WaveGlow and with Griffin-Lim:
    the streamed decoder mel equals ``Synthesizer.infer``'s for the same seed
    (atol 1e-5), the chunks tile the waveform, qmm launches = 4 x the steps
    decoded; time to first audio, total seconds and RTF.
11. Training parity: one G step and one D step at full width (B=2, T_in 32,
    T_out 64, dropout off, injected style, TF32 off) from the same seed on
    the card and on the CPU: float32 losses and grad norms within 1e-4
    relative (the adversarial losses, signed means of window scores, within
    1e-4 of their mean |score|), and the states after both steps through
    ``train.state.compare_states`` (``CARD_VS_CPU``): Adam first moments
    within rtol 1e-3 / atol 1e-3 of each tensor's largest, second moments
    within twice that, updated parameters within 1e-5 wherever Adam's step
    is conditioned (the root of its second moment at least 1e-3 of the
    tensor's largest), BatchNorm running statistics within 1e-4; bfloat16
    (fp16_run) losses within 2e-2, on the same scales.
12. Training from the corpus: phase 7's tone corpus through
    ``TextMelDataset(device="cuda")`` with a cold cache and ``DataLoader``
    (batch 8), then two G/G/D cycles at full width with fp16_run: one mel
    launch per utterance, finite losses and grad norms, and the G and D
    parameters and BatchNorm running statistics moved.
13. Training at the bench shape (bench.py: B 32, T_in 128, T_out 640,
    use_labels False, use_noise True, fp16_run, attention weight 10): one
    warm-up G/G/D cycle, three timed; G-step and D-step seconds, steps/s,
    peak memory, and a torch.profiler trace of one G step (device-busy
    share, top device operations).
14. Training loop: ``train.loop.train`` at full width (HParams defaults plus
    use_noise, no labels, fp16_run, quantized_inference, validation audio
    and a diversity probe of 3 samples, its decoder cut to 200 steps) on
    the tone corpus (24 training and 8 validation utterances, batch 8) in a
    temporary directory: 12 iterations (the G warm-up, the D-only phase to
    ``disc_warmp_up`` 8, the G/G/D alternation; attention weight off at 4;
    validation and a checkpoint at 6 and 12), then a rerun to 16 that
    auto-resumes at 12. Checks: the G/D sequence of each run against
    ``is_disc_turn`` replayed on the host; the checkpoints left against
    keep-best retention replayed on the logged validation losses; the
    iteration-12 checkpoint restored into models of other seeds bit-equal
    to the live state; finite losses. Kernels: mel 32 launches (one an
    utterance, cold cache) in the first run and 0 in the resumed one; qmm
    4 x 200 launches per validation (the probe's int8 decode). Prints
    seconds an iteration, G- and D-step seconds, validation, checkpoint
    save and restore seconds, checkpoint bytes, peak memory and the
    loader's share of the wall time.
15. Sampling from that checkpoint: ``Synthesizer.from_checkpoint(best)`` on
    the serving sentence at B = 1 with Griffin-Lim (qmm 4 x the steps
    decoded, early exit), then ``cli.inference_samples --samples 8
    --generate_audio`` (8 mels and 8 wavs; qmm 4 x 500, one decode of 8
    rows without early exit).
16. Conditioned serving: a VESUS model with labels and noise (HParams
    defaults plus ``COND_HPARAMS``, int8; memory width 1093; its random
    gate kept from firing, ``COND_GATE_BIAS``): 50 decoder steps on the card
    against the CPU for one speaker and emotion vector (as phase 4), then
    ``Synthesizer.infer_mel`` and ``tts`` (WaveGlow) of the serving
    sentence: qmm launches 4 x the steps decoded. Phase 2 holds the
    kernel on this model's two ragged matrices, (1093, 4096) and (2117,
    4096).
17. Export: ``Synthesizer.export`` of phase 5's model (B 1, text_len 96, 500
    steps, int8; the decoder one ``while_loop``), ``export.load_exported``,
    the loaded program's decode against the eager ``make_infer_fn`` at one
    seed (1e-5, lengths equal), qmm launches 4 x 500; export seconds,
    artifact bytes, and the program's decode seconds beside
    ``Synthesizer.infer``'s over the same 500 steps.
18. WaveGlow's training direction: ``WaveGlow.forward`` at the published
    width (non-zero coupling layers) on phase 5's B=8 waveform, then back
    through ``infer(sigma=1.0)``: the audio again within 1e-4 of its
    largest sample, float32, TF32 off.
19. The ``rtf`` CLI (``python -m gantron_tpu_torch.cli.rtf --hparams
    quantized_inference=True``) as subprocesses at B = 1, ``--batch 8``,
    ``--streaming`` and ``--taco_dtype bfloat16``, WaveGlow in bfloat16:
    each JSON line parsed, qmm launches 4 x its decoder steps.
20. The ``bench`` CLI (``cli.bench.main``) at bench.py's shape, shortened to
    one warm-up cycle and two trials of three G/G/D cycles through its
    function arguments: steps/s, FLOPs a step and MFU.
21. The evaluation toolkit, at ``ClassifierHParams``' widths (80 mels x 80
    frames, model_size 256) and the generator's: prints which of sklearn,
    scipy and matplotlib are installed; trains the linear and the conv
    classifier 2 epochs on 64 synthetic dB mels of 5 classes on the card and
    on the CPU from the same weights (dropout off, the same crop starts, the
    hidden layers' biases given their exact gradient, TF32 off), the card in
    lockstep with the CPU (``GRAD_TOL``: each step's gradients within 1e-3
    of each tensor's largest, 1e-2 for the conv variant's cuDNN weight
    gradients, and its Adam update within 1e-5 of the CPU's update of the
    same gradients; then on from the CPU's parameters): losses and
    accuracies within 1e-4 relative, BatchNorm statistics within 1e-4 and
    Adam moments within the gradients' tolerance of each tensor's largest,
    ``save``/``load`` bit-equal; then
    ``study_model`` on the card with phase 5's model (int8, gate pinned at
    ``COND_GATE_BIAS``, 200 steps), 6 groups x 4 samples, Griffin-Lim, 2
    classifier epochs: 24 mels, wavs and feature files, generation error
    rate 1.0, finite metrics, qmm launches 4 x 200 x 6, each stage's
    seconds; then ``cli.check_kmeans`` on 3 emotions x 8 tone wavs (mel
    launches 24, best accuracy 1.0, the CPU's result equal),
    ``cli.clustering --audio --check_clusterizations`` on the study's 24
    wavs (mel launches 24, k-means labels equal to the CPU's up to a
    permutation) and ``cli.inference_classifier`` on one wav and on the
    folder with the saved linear classifier.
22. The identification machinery, for two configurations of the repo's own
    studies at HParams defaults' widths (``IDENT_ARMS``: A, the composed
    study's "full" arm; B, the factorial study's "bit2x2_rescue_q" with the
    three code terms; identification_warmup cut to 2): (a) one float32 G
    step (B = 2, T_out 64, rollouts of 64 steps, dropout off, the gate
    pinned, the draws injected, TF32 off) on the card and on the CPU from
    the same seed, every metric within 1e-3 of max(|v|, 1e-2), lengths
    equal, the states through ``compare_states`` (``IDENT_CARD_VS_CPU``);
    then, dropout on, every decode of a step given the first one's code:
    bit-identical on the card; (b) ``train.loop.train`` for 6 iterations at
    B = 8 (fp16_run) on the arm's toy corpus (16 + 8 wavs), one validation
    with the probe cut to 100 steps (arm B: the separation probe and both
    rescue controllers): mel one launch a wav, qmm 0; logged G-step,
    probe and wall seconds, the logged identification values, peak
    memory, and one synced G step with the terms and one without them
    (the vanilla step of the same models); (c) arm A's rollout G step at
    bench.py's shape beside phase 13's vanilla one (seconds, peak memory).
23. The calibrated knob: a 28-wav leveled corpus's real levels and anchors
    on the card (mel one a wav, Spearman above 0.9), arm A's trained
    generator copied to int8 with its gate pinned, ``measure_knob`` (11
    codes x 8 draws in one decode of 200 steps: qmm 4 x 200),
    ``KnobCalibration.fit`` and a JSON round trip,
    ``Synthesizer.load_calibration`` + ``infer_mel(level=)`` at B = 1 and
    B = 4 (qmm 4 x 200 each), then qmm against its plain version and timed
    at this path's batch sizes (88 and 4).
24. Data parallel on the card (``parallel/``), each process started as
    ``chip_smoke.py --worker ...``: (a) two ranks sharing the card over
    gloo, on CUDA tensors, take one float32 G and one D step at full width
    (HParams defaults + use_noise, dropout off, the style injected, TF32
    off) on their halves of a global batch of 4, while this process takes
    the same steps on the whole batch and on it with its rows reordered:
    each rank's state within ``assert_states_match``'s tolerances of the
    one-process state (``DP_STATE_TOL``), each widened to the reordered
    steps' own distance from it where larger, and the two ranks' states and
    metrics bit-equal;
    (b) ``cli/train.py`` on two gloo ranks (``--n_gpus 2 --rank R``,
    ``mesh_shape=[2]``, fp16_run, global batch 8) on a 16-wav tone corpus
    with a cold mel cache: 6 iterations with one validation and a
    checkpoint, then a rerun that resumes to 8 from the checkpoint only the
    chief's output directory holds; the chief wrote checkpoints and
    metrics, rank 1's directory does not exist, both ranks' parameters
    equal the chief's by a sha256 broadcast from it, one whole cache file
    a wav, mel at least one launch a wav over the ranks (then 0), qmm 0;
    seconds an iteration beside phase 14's; (c) 1 then 2 iterations
    through ``torchrun --nproc_per_node=1`` with ``dist_backend=nccl``
    (float32, deterministic cuDNN): the first G step's checkpoint within
    (a)'s tolerances of the same run without a process group.
25. The study campaigns (``gantron_tpu_torch/scripts/``), as processes with
    TMPDIR a temporary directory: ``run_study --queue mode/gan:0
    continuous/cont_warm:0`` at the study model's width, 8 iterations on
    26-wav corpora; the mode arm again with ``--analyze_only``; then at once
    ``mode_attribution`` (float32, and ``quantized_inference=True`` with
    ``--select best``), ``calibrate_knob`` and ``continuous_extrapolation``
    on cut grids; then ``scripts/summarize_continuous.py`` and
    ``summarize_round4.py``. Each JSON has the committed JAX file's fields
    and names the card; mel one a cold wav (26 a study), then 0; qmm 4 x 64
    x 4 on the int8 attribution, 0 elsewhere.

Before the last line it prints one JSON line ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``. Weights are random, drawn from
fixed seeds, except in phase 15, which reads the checkpoint of phase 14.

A kernel's ``launches`` count is that of the main path of phase 5 (qmm) or 7
(mel); ``launches_by_path`` adds the other paths, each counted from 0 just
before the path runs and read just after it (the rtf CLI's counts come from
its JSON lines, each its last timed synthesis): qmm's ``study`` and mel's
``check_kmeans`` and ``clustering`` are phase 21's; ``identification`` (both
kernels, each arm's training loop) is phase 22's, qmm's ``calibration``
(the knob's sweep, ``infer_mel(level=)``) and mel's ``mode_study`` phase
23's; ``data_parallel`` (mel: each rank's launches in phase 24 (b)'s first
run; qmm: all of phase 24 (b)) phase 24's; ``studies`` phase 25's, one
count a process, read from the ``{"kernel_launches": ...}`` line each
study script prints last.
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
# Phase 16's VESUS model: labels and noise on the memory side, int8
# recurrence matrices (memory width 512 + 512 noise + 64 speaker + 5
# emotions = 1093 rows).
COND_HPARAMS = ("vesus_path=vesus,use_labels=True,use_noise=True,"
                "quantized_inference=True")
REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),   # sum order differs
       torch.bfloat16: dict(rtol=1e-2, atol=1e-6)}  # one bf16 ulp of y
# log-mel: near the 1e-5 clip floor the log turns tiny spectrum differences
# into large ones (tests/test_pallas_mel.py uses the same tolerance).
MEL_ATOL = 2e-3
MEL_SHAPES = [(8, 220500), (1, 128000), (1, 5000), (1, 300), (32, 44100)]
# Two more featurizers beside the default one: another power of two for the
# FFT route (the third filterbank of tests/test_torch_audio.py) and an n_fft
# that takes the dense route.
MEL_CONFIGS = {
    "n_fft 512, 16 kHz, 40 mels": dict(
        filter_length=512, hop_length=128, win_length=512, n_mel_channels=40,
        sampling_rate=16000, mel_fmin=50.0, mel_fmax=7000.0),
    "n_fft 800 (dense route)": dict(
        filter_length=800, hop_length=200, win_length=800, n_mel_channels=80,
        sampling_rate=22050, mel_fmin=0.0, mel_fmax=8000.0),
}
MEL_CONFIG_SHAPES = [(8, 160000), (1, 5000), (1, 300)]


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
    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.ops.quant import (dequantize, qmatmul, qmm,
                                             quantize_per_channel)

    dev = torch.device("cuda")
    mats = main_path_matrices(hp)
    # The conditioned model's (phase 16) rows that are no multiple of 16:
    # wc (1093, 4096) and w2ih (2117, 4096).
    cond = main_path_matrices(HParams.create(COND_HPARAMS))
    cond_mats = [cond[0], cond[2]]
    rng = np.random.RandomState(1)
    checks, max_err = [], 0.0

    def check(B, qm, dtype, main_path):
        nonlocal max_err
        I, O = qm.q.shape
        x = torch.from_numpy(rng.normal(0, 1, (B, I)).astype(np.float32)) \
            .to(dev, dtype)
        y = qmm(x, qm)
        repeat_equal = bool(torch.equal(y, qmm(x, qm)))
        torch.cuda.synchronize()
        ref = qmatmul(x, qm)
        err = (y.float() - ref.float()).abs().max().item()
        ok = torch.allclose(y.float(), ref.float(), **TOL[dtype]) \
            and repeat_equal
        checks.append({"B": B, "I": I, "O": O, "dtype": str(dtype)[6:],
                       "max_abs_err": err, "tol": TOL[dtype],
                       "repeat_bit_equal": repeat_equal, "ok": ok})
        log(f"[kernel] B={B:<3d} I={I:<5d} O={O:<5d} {str(dtype)[6:]:9s} "
            f"max|kernel - plain| = {err:.3e}, a second launch bit-equal: "
            f"{repeat_equal}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"qmm disagrees with its plain version at "
                                 f"B={B}, I={I}, O={O}, {dtype}")
        if main_path and dtype == torch.float32:
            max_err = max(max_err, err)

    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 8, 32):
            for qm in mats:
                check(B, qm, dtype, True)
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 8):
            for qm in cond_mats:
                check(B, qm, dtype, True)
    for B, I, O in ((3, 200, 300), (5, 77, 301)):  # no 16-byte loads
        w = torch.from_numpy(rng.normal(0, 0.05, (I, O)).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            check(B, quantize_per_channel(w.to(dev)), dtype, False)

    # Timing: one decoder step's four products, cycling through all four
    # matrices (21 MB of int8, resident in the 50 MB L2 as in decode).
    timings = {}
    for B in (1, 8, 32):
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
    """(ms, "bytes" | "operations"): the least time for ``log_mel`` on a
    (B, S) padded waveform, from the least work the function needs.
    Operations a frame: a real FFT (2.5*n_fft*log2(n_fft), the radix-2
    count), the magnitudes (3 a bin) and the filterbank's ``nnz`` nonzeros
    (2 each), at the float32 peak; bytes: the waveform, the window, the
    filterbank and the output once each."""
    frames = B * T
    ops = frames * (2.5 * n_fft * math.log2(n_fft) + 3 * n_bins + 2 * nnz)
    nbytes = 4 * (B * S + n_fft + n_bins * n_mel + B * n_mel * T)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def mel_check(mel_fn, B, N, rng, label):
    """One launch of the mel kernel on a (B, N) waveform against its plain
    version (atol MEL_ATOL) and against a second launch (bit-equal);
    returns (the check's record, y, yp, the kernel's output)."""
    from gantron_tpu_torch.ops.mel import (log_mel, log_mel_plain, mel_route,
                                           reflect_pad)

    consts, n_fft = mel_fn.consts, mel_fn.stft.filter_length
    y = torch.from_numpy(np.clip(rng.normal(0, 0.2, (B, N)), -1, 1)
                         .astype(np.float32)).cuda()
    yp = reflect_pad(y, n_fft // 2)
    out = log_mel(yp, consts)
    repeat_equal = bool(torch.equal(out, log_mel(yp, consts)))
    torch.cuda.synchronize()
    ref = log_mel_plain(yp, consts)
    err = (out - ref).abs().max().item()
    T = mel_fn.n_frames(N)
    ok = out.shape == (B, mel_fn.n_mel_channels, T) and err <= MEL_ATOL \
        and bool(torch.isfinite(out).all()) and repeat_equal
    route = mel_route(n_fft)
    log(f"[mel] {label}, {route} route, B={B:<3d} {N:>6d} samples "
        f"({T:>3d} frames): max|kernel - plain| = {err:.3e}, a second "
        f"launch bit-equal: {repeat_equal}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"mel kernel disagrees with its plain version "
                             f"({label}) at B={B}, {N} samples")
    return ({"config": label, "route": route, "B": B, "samples": N,
             "frames": T, "max_abs_err": err, "atol": MEL_ATOL,
             "repeat_bit_equal": repeat_equal, "ok": ok}, y, yp, out)


def phase_mel_kernel(hp):
    """The mel kernel against its plain version at the shapes the audio
    paths give it, and for two more featurizers (another power of two, and
    an n_fft for the dense route); then timed beside the plain version and a
    cuFFT yardstick (timed only: the port never calls torch.stft)."""
    from gantron_tpu_torch.audio.mel import MelSpectrogram
    from gantron_tpu_torch.ops.mel import log_mel, log_mel_plain

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
    for label, kw in MEL_CONFIGS.items():
        other = MelSpectrogram(device="cuda", **kw)
        for B, N in MEL_CONFIG_SHAPES:
            record = mel_check(other, B, N, rng, label)[0]
            checks.append(record)
            max_err = max(max_err, record["max_abs_err"])
    for B, N in MEL_SHAPES:
        record, y, yp, out = mel_check(mel_fn, B, N, rng, "default")
        checks.append(record)
        max_err = max(max_err, record["max_abs_err"])
        T = record["frames"]
        if (B, N) not in ((8, 220500), (1, 128000)):
            continue

        def library(y=y):
            spec = torch.stft(y, n_fft, hp.hop_length, hp.win_length, window,
                              center=True, pad_mode="reflect",
                              return_complex=True)
            return torch.log(torch.clamp(mel_fn.mel_basis @ spec.abs(),
                                         min=1e-5))

        bound_ms, bound_by = mel_bound(B, yp.shape[1], T, n_fft, n_bins,
                                       n_mel, nnz)
        t = {"B": B, "samples": N, "frames": T,
             "ms": device_ms(lambda: log_mel(yp, consts), 20),
             "eager_ms": eager_ms(lambda: log_mel(yp, consts), 20),
             "plain_ms": device_ms(lambda: log_mel_plain(yp, consts), 20),
             "library_ms": device_ms(library, 20),
             "library_max_abs_err": (library() - out).abs().max().item(),
             "call_eager_ms": eager_ms(lambda: mel_fn(y), 20),
             "bound_ms": bound_ms, "bound_by": bound_by}
        timings[f"B={B}x{N}"] = t
        log(f"[mel] B={B} x {N} samples, device time: kernel "
            f"{t['ms'] * 1e3:.1f} us, "
            f"plain {t['plain_ms'] * 1e3:.1f} us, "
            f"torch.stft + mel {t['library_ms'] * 1e3:.1f} us (max|stft - "
            f"kernel| {t['library_max_abs_err']:.2e}), bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by}); issued eagerly: "
            f"kernel {t['eager_ms'] * 1e3:.1f} us, MelSpectrogram call "
            f"{t['call_eager_ms'] * 1e3:.1f} us")
    return {"checks": checks, "max_abs_err": max_err, "timings": timings}


def phase_parity(hp, steps=50, emotions=None, speaker=None, tag="parity",
                 gate_bias=None):
    """Full-width decode on the card against the port on the CPU (with a
    VESUS model, for the given emotions and speaker ids; ``gate_bias``
    replaces the gate readout's bias)."""
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
        if gate_bias is not None:
            model.decoder.gate_b.data.fill_(gate_bias)
        t0 = time.perf_counter()
        out = model.infer(ids, style, emotions, speaker, max_steps=steps)
        outs[device] = [o.cpu() for o in out]
        log(f"[{tag}] {device}: {steps} steps in "
            f"{time.perf_counter() - t0:.2f} s")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default again
    cpu, gpu = outs["cpu"], outs["cuda"]
    tol = 1e-3  # float32 sum order, carried through 50 autoregressive steps
    errors = {}
    for name, i in (("mel", 0), ("mel_postnet", 1), ("gate", 2)):
        err = errors[name] = (gpu[i] - cpu[i]).abs().max().item()
        log(f"[{tag}] max|card - cpu| {name} = {err:.3e} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"card and CPU decodes differ in {name}")
    # A stop decision may flip only where the gate sits at the threshold.
    thr = float(np.log(hp.gate_threshold / (1 - hp.gate_threshold)))
    for b, (lc, lg) in enumerate(zip(cpu[4].tolist(), gpu[4].tolist())):
        step = min(lc, lg) - 1
        if lc != lg and abs(cpu[2][b, step].item() - thr) > tol:
            raise AssertionError(f"lengths differ: cpu {lc}, card {lg}")
    log(f"[{tag}] lengths cpu {cpu[4].tolist()} card {gpu[4].tolist()}")
    return {"steps": steps, "tol": tol, "max_abs_err": errors,
            "lengths_cpu": cpu[4].tolist(), "lengths_card": gpu[4].tolist()}


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
            wavs[label] = (mels, wav)
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
    return results, total_launches, synth, waveglow, wavs["B=8"]


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
    result = trace_summary(prof, out_dir, "decode_b1_trace.json", steps)
    if result is None:
        log("[trace] the profiler recorded no kernels: device busy share "
            "not measured")
        return None
    log(f"[trace] B=1, {steps} decoder steps under the profiler: span "
        f"{result['span_us'] / 1e3:.2f} ms, device busy "
        f"{result['device_busy_us'] / 1e3:.3f} ms "
        f"({100 * result['busy_share_under_profiler']:.1f}%), "
        f"{result['kernel_launches']} kernels "
        f"({result['kernel_launches'] / steps:.1f} a step); trace in "
        f"{result['path']}")
    for item in result["top_kernels"]:
        log(f"[trace]   {item['total_us'] / steps:8.2f} us/step "
            f"{item['count'] / steps:5.1f}/step  {item['name']}")
    return result


def trace_summary(prof, out_dir, name, steps, top=10):
    """A finished ``torch.profiler`` run read from its chrome trace (written
    to ``out_dir/name``): the span of all events, the device's busy time
    (the union of kernel, copy and fill intervals), and the device time by
    kernel name; None if it holds no kernel."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not kernels:
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"steps": steps, "span_us": span, "device_busy_us": busy,
            "busy_share_under_profiler": busy / span,
            "kernel_launches": len(kernels), "path": path,
            "top_kernels": [{"name": n[:80], "count": c, "total_us": d}
                            for n, (c, d) in ranked]}


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


def phase_streaming(synth, hp, gpu, chunk=40, seed=1):
    """Streaming serving at chunk ``chunk``: the B=1 sentence and the B=8
    batch of phase 5, with WaveGlow and with Griffin-Lim."""
    from gantron_tpu_torch.models.waveglow import (WaveGlow, WaveGlowConfig,
                                                   random_params)
    from gantron_tpu_torch.ops.mel import log_mel
    from gantron_tpu_torch.ops.quant import qmm
    from gantron_tpu_torch.tts import StreamingSynthesizer

    K, hop, sr = hp.n_frames_per_step, hp.hop_length, hp.sampling_rate
    cfg = WaveGlowConfig()
    waveglow = WaveGlow(cfg, random_params(torch.Generator().manual_seed(3),
                                           cfg), device="cuda")
    results = {}
    for vocoder, wg in (("WaveGlow", waveglow), ("Griffin-Lim", None)):
        streamer = StreamingSynthesizer(hp, synth.model, wg, chunk=chunk,
                                        device="cuda")
        for label, texts in (("B=1", [RTF_TEXT]), ("B=8", BATCH_TEXTS)):
            ids = pad_ids(texts, hp.text_cleaners)
            ref = synth.infer(ids, seed=seed)
            torch.cuda.synchronize()
            log_mel.launches = qmm.launches = 0  # the streaming path starts
            chunks = list(streamer.stream(ids, seed=seed))
            torch.cuda.synchronize()
            launches, mel_launches = qmm.launches, log_mel.launches
            frames = streamer.last_mel.shape[2]
            decoded = frames // K  # every step decoded, the last segment's too
            where = f"streaming, {vocoder}, {label}"
            if launches != 4 * decoded:
                raise AssertionError(f"{where}: {launches} qmm launches for "
                                     f"{decoded} decoder steps")
            err = (streamer.last_mel - ref[0][:, :, :frames]).abs().max() \
                .item()
            rest = ref[0][:, :, frames:].abs().max().item() \
                if ref[0].shape[2] > frames else 0.0
            if not (err <= 1e-5 and rest == 0.0 and np.array_equal(
                    streamer.last_lengths, ref[4].cpu().numpy())):
                raise AssertionError(
                    f"{where}: streamed decoder mel differs from "
                    f"Synthesizer.infer's by {err} (beyond the stream: "
                    f"{rest}), lengths {streamer.last_lengths.tolist()} vs "
                    f"{ref[4].tolist()}")
            samples = sum(c.shape[1] for c in chunks)
            if samples != frames * hop or not all(
                    np.isfinite(c).all() for c in chunks):
                raise AssertionError(f"{where}: {samples} samples in "
                                     f"{len(chunks)} chunks for {frames} "
                                     "frames, or not finite")
            wav, lengths, ttfa, total = streamer.synthesize(ids, seed=seed)
            audio_s = int(lengths.max()) * hop / sr
            r = {"chunk": chunk, "chunks": len(chunks), "frames": frames,
                 "steps_decoded": decoded, "qmm_launches": launches,
                 "mel_launches": mel_launches,
                 "max_abs_err_vs_infer": err, "samples": samples,
                 "lengths": lengths.tolist(), "ttfa_s": ttfa,
                 "total_s": total, "audio_s": audio_s,
                 "rtf": total / audio_s}
            results[f"{vocoder} {label}"] = r
            log(f"[stream] {vocoder} {label}, chunk {chunk}: {len(chunks)} "
                f"chunks tile {samples} samples; decoder mel vs "
                f"Synthesizer.infer max |d| {err:.2e}; {launches} qmm "
                f"launches for {decoded} steps; time to first audio "
                f"{ttfa:.3f} s, total {total:.3f} s for {audio_s:.3f} s of "
                f"audio (RTF {r['rtf']:.4f}) [{gpu}]")
    return results


def path_launches(results, key):
    return sum(r[key] for r in results.values())


def train_batch(hp, B, T_in, T_out, seed=0):
    """A numpy ``Batch`` as bench.py makes one: random ids and log-mel-like
    values, ragged lengths (the first sample full length), gate targets 1
    from each last frame on."""
    from gantron_tpu_torch.train.step import Batch

    rng = np.random.RandomState(seed)
    text = rng.randint(1, hp.n_symbols, (B, T_in)).astype(np.int32)
    text_lengths = rng.randint(T_in // 2, T_in + 1, B).astype(np.int32)
    text_lengths[0] = T_in
    mels = (rng.randn(B, hp.n_mel_channels, T_out) * 1.5 - 6).astype(
        np.float32)
    output_lengths = rng.randint(T_out // 2, T_out + 1, B).astype(np.int32)
    output_lengths[0] = T_out
    gate = np.zeros((B, T_out), np.float32)
    for b in range(B):
        text[b, text_lengths[b]:] = 0
        mels[b, :, output_lengths[b]:] = 0
        gate[b, output_lengths[b] - 1:] = 1
    return Batch(text, text_lengths, mels, gate, np.zeros(B, np.int32),
                 np.zeros((B, 5), np.float32), output_lengths)


def train_steps(hp, seed, batch, device, dropout=True):
    from gantron_tpu_torch.models.modules import disable_dropout
    from gantron_tpu_torch.train.state import create_train_state
    from gantron_tpu_torch.train.step import make_train_steps

    state, G, D, g_tx, d_tx = create_train_state(hp, seed, batch, device)
    if not dropout:
        disable_dropout(G)
        disable_dropout(D)
    return state, make_train_steps(hp, G, D, g_tx, d_tx)


G_LR, D_LR, ATTN_W = 1e-3, 7e-4, 10.0
# Card against CPU after one float32 G and D step from the same state
# (train/state.py::compare_states). These are looser than the CPU tests'
# port-vs-JAX tolerances (1e-5, floor 1e-4): there both sides sum in the
# same order at tiny widths, here cuDNN and cuBLAS sum the full-width
# products in other orders than the CPU, and Adam's first step divides
# each first moment by the root of its second, scaling those roundings up.
CARD_VS_CPU = dict(moment_tol=1e-3, param_rtol=0.0, param_atol=1e-5,
                   floor=1e-3, noise_tol=1e-5, stats_tol=1e-4)


def phase_train_parity(smi):
    """One G step and one D step from the same seed on the card and on the
    CPU, at full width and a short batch, dropout off, TF32 off."""
    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.train.state import compare_states
    from gantron_tpu_torch.train.step import pad_mel_to_window, to_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    for mode in ("float32", "bfloat16"):
        hp = HParams.create("use_noise=True,use_labels=False"
                            + (",fp16_run=True" if mode == "bfloat16"
                               else ""))
        batch = train_batch(hp, 2, 32, 64, seed=1)
        style = torch.from_numpy(np.random.RandomState(2).rand(
            2, 1, hp.noise_size).astype(np.float32))
        runs = {}
        for device in ("cpu", "cuda"):
            state, (g_step, d_step, _) = train_steps(hp, 0, batch, device,
                                                     dropout=False)
            b = to_device(batch, device)
            t0 = time.perf_counter()
            state, gm, (mel, lens) = g_step(state, b, G_LR, ATTN_W,
                                            style=style.to(device))
            state, dm = d_step(state, b.mels, b.output_lengths, mel, lens,
                               D_LR)
            metrics = {k: float(v) for k, v in {**gm, **dm}.items()}
            with torch.no_grad():  # the scale of the adversarial losses
                scale = {k: state.d_model.scores(pad_mel_to_window(
                    x, hp.discriminator_window).transpose(1, 2), False)
                    .abs().mean().item()
                    for k, x in (("fake", mel), ("real", b.mels))}
            runs[device] = {"s": time.perf_counter() - t0,
                            "metrics": metrics, "scale": scale,
                            "state": state}
        cpu, gpu = runs["cpu"], runs["cuda"]
        # Losses and grad norms relative to themselves, the adversarial
        # losses (signed means of window scores that cancel in part)
        # relative to the mean |score| of their inputs; bf16: losses only.
        tol = 1e-4 if mode == "float32" else 2e-2
        adv = {"adversarial_loss": "fake", "real_loss": "real",
               "fake_loss": "fake", "discriminator_loss": "both"}
        cpu["scale"]["both"] = max(cpu["scale"].values())
        worst = {}
        for k, v in cpu["metrics"].items():
            if mode == "bfloat16" and "loss" not in k:
                continue
            scale = cpu["scale"][adv[k]] if k in adv else abs(v)
            worst[k] = abs(gpu["metrics"][k] - v) / max(scale, 1e-6)
            if not worst[k] <= tol:
                raise AssertionError(f"training parity ({mode}): {k} card "
                                     f"{gpu['metrics'][k]} vs CPU {v}")
        result = {"metrics_rel_err": worst, "cpu_s": cpu["s"],
                  "card_s": gpu["s"]}
        if mode == "float32":
            result.update(compare_states(gpu["state"], cpu["state"],
                                         what="training parity, card vs "
                                         "CPU", **CARD_VS_CPU))
        results[mode] = result
        log(f"[train-parity] {mode}: G and D step on the CPU {cpu['s']:.2f} s"
            f", on the card {gpu['s']:.2f} s; worst metric error "
            f"{max(worst.values()):.2e} of its scale [{smi}]")
        if mode == "float32":
            log("[train-parity]   worst share of the tolerance: "
                + "; ".join(f"{k} {result[k][0]:.3f} ({result[k][1]})"
                            for k in ("first_moment", "second_moment",
                                      "param", "stats"))
                + "; gradient noise of the conv biases before BatchNorm "
                f"{result['bn_fed_bias_noise']:.2e} of the largest first "
                "moment")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default again
    return results


def phase_train_corpus(smi, n_utts=32, B=8):
    """The tone corpus through the card's featurizer into two G/G/D cycles
    at full width, fp16_run."""
    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.data import toy
    from gantron_tpu_torch.data.dataset import DataLoader, TextMelDataset
    from gantron_tpu_torch.ops.mel import log_mel
    from gantron_tpu_torch.ops.quant import qmm
    from gantron_tpu_torch.train.step import to_device

    hp = HParams.create("use_noise=True,use_labels=False,fp16_run=True")
    with tempfile.TemporaryDirectory() as root:
        wav_dir, train_list, _ = toy.build_corpus(
            root, n_utts=n_utts, n_train=n_utts, min_chars=20, max_chars=141,
            seed=0)
        dataset = TextMelDataset([train_list], hp, wav_dir,
                                 os.path.join(root, "cache"), device="cuda")
        torch.cuda.synchronize()
        log_mel.launches = qmm.launches = 0  # the training path starts here
        t0 = time.perf_counter()
        batches = list(DataLoader(dataset, hp, batch_size=B))
        t_data = time.perf_counter() - t0
        state, (g_step, d_step, _) = train_steps(hp, 0, batches[0], "cuda")
        G, D = state.g_model, state.d_model
        before = [t.detach().clone() for t in
                  list(G.parameters()) + list(G.buffers())
                  + list(D.parameters())]
        metrics, t_steps = [], []
        for cycle in range(2):
            b = to_device(batches[cycle], "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, gm, _ = g_step(state, b, G_LR, ATTN_W)
            state, gm2, (mel, lens) = g_step(state, b, G_LR, ATTN_W)
            state, dm = d_step(state, b.mels, b.output_lengths, mel, lens,
                               D_LR)
            torch.cuda.synchronize()
            t_steps.append(time.perf_counter() - t0)
            metrics += [gm, gm2, dm]
        launches, qmm_launches = log_mel.launches, qmm.launches  # just after
    after = list(G.parameters()) + list(G.buffers()) + list(D.parameters())
    n_g, n_buf = len(list(G.parameters())), len(list(G.buffers()))
    moved = [not torch.equal(a, b) for a, b in zip(before, after)]
    values = {k: float(v) for m in metrics for k, v in m.items()}
    if launches != n_utts or qmm_launches:
        raise AssertionError(f"training from the corpus: {launches} mel "
                             f"launches for {n_utts} utterances, "
                             f"{qmm_launches} qmm launches")
    if not all(np.isfinite(float(v)) for m in metrics for v in m.values()):
        raise AssertionError(f"training from the corpus: a loss or grad "
                             f"norm is not finite: {metrics}")
    if not (any(moved[:n_g]) and any(moved[n_g:n_g + n_buf])
            and any(moved[n_g + n_buf:])):
        raise AssertionError("training from the corpus: G, its BatchNorm "
                             "statistics or D did not move")
    result = {"utterances": n_utts, "mel_launches": launches,
              "qmm_launches": qmm_launches,
              "batches": len(batches), "data_s": t_data,
              "T_out": [int(b.mels.shape[2]) for b in batches[:2]],
              "cycle_s": t_steps, "last_metrics": values,
              "moved": {"g_params": sum(moved[:n_g]),
                        "g_buffers": sum(moved[n_g:n_g + n_buf]),
                        "d_params": sum(moved[n_g + n_buf:])}}
    log(f"[train-corpus] {n_utts} utterances featurized on the card in "
        f"{t_data:.3f} s ({launches} mel launches), two G/G/D cycles on "
        f"batches of T_out {result['T_out']}: {t_steps[0]:.2f} s, "
        f"{t_steps[1]:.2f} s; generator loss "
        f"{values['generator_loss']:.4f}, discriminator loss "
        f"{values['discriminator_loss']:.4f}; moved {result['moved']} "
        f"[{smi}]")
    return result


def phase_train_bench(smi, out_dir, B=32, T_in=128, T_out=640):
    """The bench.py training shape: G/G/D cycles timed step by step, peak
    memory, and a trace of one G step."""
    from torch.profiler import ProfilerActivity, profile

    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.train.step import to_device

    hp = HParams.create("use_labels=False,use_noise=True,fp16_run=True")
    batch = to_device(train_batch(hp, B, T_in, T_out, seed=0), "cuda")
    state, (g_step, d_step, _) = train_steps(hp, 0, batch, "cuda")

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def cycle(state):
        (state, _, _), t_g1 = timed(g_step, state, batch, G_LR, ATTN_W)
        (state, gm, (mel, lens)), t_g2 = timed(g_step, state, batch, G_LR,
                                               ATTN_W)
        (state, dm), t_d = timed(d_step, state, batch.mels,
                                 batch.output_lengths, mel, lens, D_LR)
        return state, gm, dm, (t_g1, t_g2, t_d)

    state, gm, dm, warm = cycle(state)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        state, gm, dm, t = cycle(state)
        times.append(t)
    peak = torch.cuda.max_memory_allocated()
    metrics = {k: float(v) for k, v in {**gm, **dm}.items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"bench shape: a loss is not finite: {metrics}")
    g_s = [t for c in times for t in c[:2]]
    d_s = [c[2] for c in times]
    cycle_s = sum(map(sum, times))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, t_prof = timed(g_step, state, batch, G_LR, ATTN_W)
    trace = trace_summary(prof, out_dir, "train_g_step_trace.json", 1)
    result = {"B": B, "T_in": T_in, "T_out": T_out, "warmup_cycle_s": warm,
              "g_step_s": g_s, "d_step_s": d_s,
              "steps_per_s": 9 / cycle_s, "peak_memory_bytes": peak,
              "profiled_g_step_s": t_prof, "trace": trace,
              "metrics": metrics}
    log(f"[train-bench] B={B}, T_in {T_in}, T_out {T_out}, fp16_run: G step "
        f"{min(g_s):.3f}-{max(g_s):.3f} s, D step {min(d_s):.3f}-"
        f"{max(d_s):.3f} s, {result['steps_per_s']:.3f} steps/s over three "
        f"G/G/D cycles (warm-up cycle {sum(warm):.2f} s); peak memory "
        f"{peak / 2**30:.2f} GiB; generator loss "
        f"{metrics['generator_loss']:.4f} [{smi}]")
    if trace is None:
        log("[train-bench] the profiler recorded no kernels: device busy "
            "share not measured")
    else:
        log(f"[train-bench] one G step under the profiler ({t_prof:.3f} s): "
            f"span {trace['span_us'] / 1e6:.3f} s, device busy "
            f"{trace['device_busy_us'] / 1e6:.3f} s "
            f"({100 * trace['busy_share_under_profiler']:.1f}%), "
            f"{trace['kernel_launches']} device operations; trace in "
            f"{trace['path']}")
        for item in trace["top_kernels"]:
            log(f"[train-bench]   {item['total_us'] / 1e3:9.2f} ms "
                f"{item['count']:7d}x  {item['name']}")
    return result


def replay_schedule(hp, start, stop):
    """The G/D sequence of iterations [start, stop) of a loop that starts
    (or resumes) at ``start``: counters and fake buffer fresh, as
    ``train.loop.train`` begins."""
    from gantron_tpu_torch.train.loop import advance_counters, is_disc_turn

    gen, disc, buf, seq = 1, 0, 0, ""
    for it in range(start, stop):
        d = is_disc_turn(it, gen, disc, hp, buf)
        if not d:
            buf = min(buf + 1, max(hp.d_freq, 1))
        gen, disc = advance_counters(d, it, gen, disc, hp)
        seq += "D" if d else "G"
    return seq


def expected_checkpoints(validations):
    """The checkpoint names that keep-best retention leaves after saving
    ``validations`` ([(iteration, val loss)]) with one manager."""
    kept, prev, prev_loss = [], None, math.inf
    best, best_loss = None, math.inf
    for it, v in validations:
        name = f"iter={it}_val-loss={round(v, 6)}.ckpt"
        kept.append(name)
        if prev is not None and v < prev_loss:
            kept.remove(prev)
        if v < best_loss:
            if best in kept:
                kept.remove(best)
            best, best_loss = name, v
        prev, prev_loss = name, v
    return kept


def read_metrics(path):
    """step -> merged records of a MetricLogger JSONL."""
    out = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            out.setdefault(r.pop("step"), {}).update(r)
    return out


def states_bit_equal(a, b):
    same = a.step == b.step
    for x, y in ((a.g_model, b.g_model), (a.d_model, b.d_model)):
        same &= all(torch.equal(u, v) for u, v in
                    zip(x.state_dict().values(), y.state_dict().values()))
    for x, y in ((a.g_opt_state, b.g_opt_state),
                 (a.d_opt_state, b.d_opt_state)):
        same &= x.count == y.count and all(
            torch.equal(u, v) for u, v in zip(x.mu + x.nu, y.mu + y.nu))
    for g in ("dropout_generator", "noise_generator"):
        same &= torch.equal(getattr(a, g).get_state(),
                            getattr(b, g).get_state())
    return bool(same)


LOOP_HPARAMS = ("use_noise=True,use_labels=False,fp16_run=True,"
                "quantized_inference=True,validation_audio=True,"
                "validation_sample_diversity=3")


def phase_train_loop(smi, root, n_utts=32, n_val=8, B=8, probe_steps=200):
    """``train.loop.train`` at full width on the tone corpus: 12 iterations
    (G warm-up, D-only phase, alternation), then a rerun to 16 that
    auto-resumes at 12; the checkpoints it leaves in ``root``."""
    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.data import toy
    from gantron_tpu_torch.models.discriminator import make_discriminator
    from gantron_tpu_torch.models.tacotron2 import Tacotron2
    from gantron_tpu_torch.ops.mel import log_mel
    from gantron_tpu_torch.ops.quant import qmm
    from gantron_tpu_torch.train.checkpoint import CheckpointManager
    from gantron_tpu_torch.train.loop import train
    from gantron_tpu_torch.train.state import wrap_models
    from gantron_tpu_torch.utils.logging import MetricLogger

    hp = HParams.create(LOOP_HPARAMS)
    hp.add_params(dict(batch_size=B, iterations=12, disc_warmp_up=8,
                       iters_per_checkpoint=6, attn_steps=4,
                       max_decoder_steps=probe_steps))
    wav_dir, train_list, val_list = toy.build_corpus(
        root, n_utts=n_utts, n_train=n_utts - n_val, min_chars=20,
        max_chars=141, seed=0)
    hp.training_files, hp.validation_files = [train_list], [val_list]
    out = os.path.join(root, "run")
    runs = []
    for run, iterations in enumerate((12, 16)):
        hp.iterations = iterations
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        log_mel.launches = qmm.launches = 0  # the training loop starts here
        t0 = time.perf_counter()
        state, it = train(out, None, False, hp, wav_dir,
                          logger=MetricLogger(out, run_name=f"run{run}",
                                              quiet=True), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append({"state": state, "iteration": it, "wall_s": wall,
                     "mel_launches": log_mel.launches,
                     "qmm_launches": qmm.launches,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                     "metrics": read_metrics(
                         os.path.join(out, f"run{run}.metrics.jsonl"))})
    first, second = runs
    ckpt = CheckpointManager(out)
    checks = {}

    def check(name, ok, detail):
        checks[name] = bool(ok)
        if not ok:
            raise AssertionError(f"training loop: {name}: {detail}")

    check("iterations", first["iteration"] == 12 == first["state"].step
          and second["iteration"] == 16 == second["state"].step
          and min(second["metrics"]) == 12,
          f"{first['iteration']}, {second['iteration']}, steps "
          f"{first['state'].step}, {second['state'].step}")
    seqs = []
    for r, start in ((first, 0), (second, 12)):
        steps = [s for s in sorted(r["metrics"]) if s < r["iteration"]
                 and ("Generator loss" in r["metrics"][s]
                      or "Discriminator loss" in r["metrics"][s])]
        seqs.append("".join("D" if "Discriminator loss" in r["metrics"][s]
                            else "G" for s in steps))
        check(f"schedule from {start}",
              steps == list(range(start, r["iteration"]))
              and seqs[-1] == replay_schedule(hp, start, r["iteration"]),
              f"{seqs[-1]} vs {replay_schedule(hp, start, r['iteration'])}")
    losses = [v for r in runs for m in r["metrics"].values()
              for k, v in m.items() if "loss" in k.lower()]
    check("finite losses", losses and all(np.isfinite(losses)), losses)
    vals = [[(s, m["Validation mel loss"] + m["Validation gate loss"])
             for s, m in sorted(r["metrics"].items())
             if "Validation mel loss" in m] for r in runs]
    want = sorted(expected_checkpoints(vals[0])
                  + expected_checkpoints(vals[1]))
    have = sorted(n for n in os.listdir(out) if n.endswith(".ckpt"))
    sidecars = all(os.path.exists(os.path.join(out, n + ".meta.json"))
                   for n in have)
    check("checkpoint names and retention", have == want and sidecars,
          f"{have} vs {want}")
    check("mel launches (cold cache, then warm)",
          first["mel_launches"] == n_utts and second["mel_launches"] == 0,
          f"{first['mel_launches']}, {second['mel_launches']}")
    n_val_runs = [len(v) for v in vals]
    check("qmm launches (the diversity probe)",
          [r["qmm_launches"] for r in runs]
          == [4 * probe_steps * n for n in n_val_runs],
          f"{[r['qmm_launches'] for r in runs]} for {n_val_runs} probes of "
          f"{probe_steps} steps")
    # restore(save(state)): the iteration-12 checkpoint read into models
    # from another seed, against the live state the first run returned.
    path12 = [os.path.join(out, n) for n in have
              if CheckpointManager.parse_name(n)[0] == 12][0]
    fresh = wrap_models(hp, Tacotron2(hp, device="cuda", seed=5),
                        make_discriminator(hp, device="cuda", seed=6), 7)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.restore(path12, fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check("restore(save(state)) bit-equal",
          states_bit_equal(fresh, first["state"]), path12)

    def durations(r, key):
        return [m[key] for m in r["metrics"].values() if key in m]

    result = {"hparams": LOOP_HPARAMS, "batch_size": B,
              "probe_max_decoder_steps": probe_steps, "checks": checks,
              "schedules": seqs, "checkpoints": have,
              "checkpoint_bytes": os.path.getsize(path12),
              "restore_s": restore_s, "validations": vals}
    for name, r in (("first", first), ("resumed", second)):
        # An iteration: its wait for the batch and its G or D step.
        step_s = [m["Data duration"] + m.get("Generation duration", m.get(
            "Discriminator duration")) for m in r["metrics"].values()
            if "Data duration" in m]
        data_s = sum(durations(r, "Data duration"))
        result[name] = {
            "iterations_run": len(step_s), "wall_s": r["wall_s"],
            "s_per_iteration": float(np.median(step_s)),
            "g_step_s": durations(r, "Generation duration"),
            "d_step_s": durations(r, "Discriminator duration"),
            "validation_s": durations(r, "Validation duration"),
            "checkpoint_save_s": durations(r, "Checkpoint duration"),
            "data_wait_s": data_s, "loader_share": data_s / r["wall_s"],
            "mel_launches": r["mel_launches"],
            "qmm_launches": r["qmm_launches"],
            "peak_memory_bytes": r["peak_memory_bytes"],
            "sample_diversity": durations(r, "Sample diversity")}
    f, s2 = result["first"], result["resumed"]
    log(f"[train-loop] {n_utts - n_val} + {n_val} utterances, B={B}, "
        f"{LOOP_HPARAMS}: 12 iterations ({seqs[0]}) in {f['wall_s']:.2f} s "
        f"(median {f['s_per_iteration']:.3f} s an iteration; G steps "
        f"{min(f['g_step_s']):.3f}-{max(f['g_step_s']):.3f} s, D steps "
        f"{min(f['d_step_s']):.3f}-{max(f['d_step_s']):.3f} s), then "
        f"resumed at 12 to 16 ({seqs[1]}) in {s2['wall_s']:.2f} s [{smi}]")
    log(f"[train-loop] validation (teacher-forced, diversity probe of 3 x "
        f"{probe_steps} int8 steps, Griffin-Lim media) "
        f"{', '.join(f'{v:.3f}' for v in f['validation_s'] + s2['validation_s'])}"
        f" s; checkpoint save "
        f"{', '.join(f'{v:.3f}' for v in f['checkpoint_save_s'] + s2['checkpoint_save_s'])}"
        f" s, restore {restore_s:.3f} s, {result['checkpoint_bytes']} bytes; "
        f"peak memory {f['peak_memory_bytes']} / {s2['peak_memory_bytes']} "
        f"bytes; loader wait {f['data_wait_s']:.3f} s "
        f"({100 * f['loader_share']:.1f}% of the wall time)")
    log(f"[train-loop] launches: mel {f['mel_launches']} (cold cache) then "
        f"{s2['mel_launches']}; qmm {f['qmm_launches']} then "
        f"{s2['qmm_launches']}; checkpoints {have}; checks {checks}")
    return result, ckpt.best()


def phase_sampling(smi, best, root, n_samples=8):
    """The trained checkpoint served: ``Synthesizer.from_checkpoint`` at
    B = 1 with Griffin-Lim, then ``cli.inference_samples`` (random styles,
    ``--generate_audio``)."""
    from gantron_tpu_torch.cli import inference_samples
    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.data.wav import read_wav
    from gantron_tpu_torch.ops.mel import log_mel
    from gantron_tpu_torch.ops.quant import qmm
    from gantron_tpu_torch.tts import Synthesizer

    hp = HParams.create(LOOP_HPARAMS)
    K, hop = hp.n_frames_per_step, hp.hop_length
    synth = Synthesizer.from_checkpoint(best, hp, device="cuda")
    torch.cuda.synchronize()
    log_mel.launches = qmm.launches = 0  # Synthesizer.tts starts here
    t0 = time.perf_counter()
    wav = synth.tts(RTF_TEXT, seed=3)
    tts_s = time.perf_counter() - t0
    tts_qmm = qmm.launches
    mel, L = synth.infer_mel(RTF_TEXT, seed=3)
    expected = min(L, max(L, hp.filter_length // hop + 1) - 1) * hop
    if wav.shape != (expected,) or not np.isfinite(wav).all() \
            or tts_qmm != 4 * (L // K):
        raise AssertionError(f"sampling: tts() gave {wav.shape} samples "
                             f"(expected {expected}), {tts_qmm} qmm launches "
                             f"for {L // K} steps")
    out = os.path.join(root, "samples")
    torch.cuda.synchronize()
    log_mel.launches = qmm.launches = 0  # cli.inference_samples starts here
    t0 = time.perf_counter()
    inference_samples.main(["-c", best, "-o", out, "--samples",
                            str(n_samples), "--generate_audio", "--hparams",
                            LOOP_HPARAMS, "--seed", "0"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_qmm = qmm.launches
    names = sorted(os.listdir(out))
    want = sorted(f"{i}.{e}" for i in range(n_samples) for e in ("npy", "wav"))
    mels = [np.load(os.path.join(out, f"{i}.npy")) for i in range(n_samples)]
    wavs = [read_wav(os.path.join(out, f"{i}.wav"))[0]
            for i in range(n_samples)]
    if names != want or cli_qmm != 4 * hp.max_decoder_steps or not all(
            np.isfinite(m).all() and m.shape[0] == hp.n_mel_channels
            and np.isfinite(w).all() and len(w) > 0
            for m, w in zip(mels, wavs)):
        raise AssertionError(f"sampling: files {names}, {cli_qmm} qmm "
                             f"launches for {hp.max_decoder_steps} steps")
    result = {"checkpoint": os.path.basename(best), "tts_s": tts_s,
              "tts_frames": L, "tts_samples": len(wav),
              "tts_qmm_launches": tts_qmm, "cli_s": cli_s,
              "cli_samples": n_samples, "cli_qmm_launches": cli_qmm,
              "cli_frames": [int(m.shape[1]) for m in mels],
              "qmm_launches": tts_qmm + cli_qmm}
    log(f"[sampling] {os.path.basename(best)}: Synthesizer.tts at B=1 "
        f"(Griffin-Lim) {L} frames -> {len(wav)} samples in {tts_s:.3f} s, "
        f"{tts_qmm} qmm launches; cli.inference_samples --samples "
        f"{n_samples} --generate_audio: {n_samples} mels "
        f"({result['cli_frames']} frames) and wavs in {cli_s:.3f} s, "
        f"{cli_qmm} qmm launches [{smi}]")
    return result


def timed(fn):
    """(fn(), seconds) with the card's work finished on both sides."""
    from gantron_tpu_torch.utils.profiling import StepTimer

    card = torch.device("cuda")
    timer = StepTimer(sync=True)
    timer.start(card)
    out = fn()
    return out, timer.stop(card)


# The conditioned model's random gate readout fires at the first step; with
# its bias at this value it never fires, and phase 16 decodes every step up
# to the cap, as phase 5's random model does.
COND_GATE_BIAS = -20.0


def phase_conditioned(waveglow, gpu, steps=50):
    """A VESUS model with labels and noise (its gate bias at
    ``COND_GATE_BIAS``): the card against the CPU for ``steps`` decoder
    steps, then ``Synthesizer.infer_mel`` and ``tts`` (WaveGlow) of the
    serving sentence for one speaker and emotion."""
    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.ops.quant import qmm
    from gantron_tpu_torch.tts import Synthesizer

    hp = HParams.create(COND_HPARAMS)
    K, hop, sr = hp.n_frames_per_step, hp.hop_length, hp.sampling_rate
    emotions = np.array([[0.1, 0.7, 0.05, 0.1, 0.05]], np.float32)
    speaker = np.array([17])
    parity = phase_parity(hp, steps, torch.from_numpy(emotions),
                          torch.from_numpy(speaker), tag="conditioned",
                          gate_bias=COND_GATE_BIAS)
    synth = Synthesizer(hp, device="cuda", seed=0)
    synth.model.decoder.gate_b.data.fill_(COND_GATE_BIAS)
    width = (hp.encoder_embedding_dim + hp.noise_size + hp.speakers_embedding
             + 5)  # 1093 at the defaults
    if synth.model.memory_dim != width:
        raise AssertionError(f"memory width {synth.model.memory_dim}")

    def infer_mel():
        return synth.infer_mel(RTF_TEXT, emotions=emotions, speaker=speaker,
                               seed=2)

    def tts():
        return synth.tts(RTF_TEXT, waveglow, emotions=emotions,
                         speaker=speaker, seed=2)

    infer_mel(), tts()  # warm-up
    torch.cuda.synchronize()
    qmm.launches = 0  # the conditioned serving path starts here
    (mel, L), mel_s = timed(infer_mel)
    mel_launches = qmm.launches
    wav, tts_s = timed(tts)
    launches = qmm.launches  # read just after the path
    if mel.shape != (hp.n_mel_channels, L) or not torch.isfinite(mel).all() \
            or wav.shape != (L * hop,) or not np.isfinite(wav).all() \
            or mel_launches != 4 * (L // K) or launches != 8 * (L // K):
        raise AssertionError(f"conditioned serving: mel {tuple(mel.shape)}, "
                             f"wav {wav.shape}, {mel_launches} and "
                             f"{launches} qmm launches for {L // K} steps")
    result = {"parity": parity, "frames": L, "infer_mel_s": mel_s,
              "tts_s": tts_s, "rtf": tts_s / (L * hop / sr),
              "qmm_launches": launches, "memory_dim": width}
    log(f"[conditioned] {COND_HPARAMS}, speaker 17: infer_mel {L} frames "
        f"in {mel_s:.3f} s ({mel_launches} qmm launches), tts with "
        f"WaveGlow {tts_s:.3f} s (RTF {result['rtf']:.4f}); {launches} qmm "
        f"launches on the path [{gpu}]")
    return result


def phase_export(synth, hp, gpu, root, steps=500, text_len=96, seed=4):
    """``Synthesizer.export`` of the serving model (B 1, text_len 96,
    ``steps`` decoder steps, int8), loaded with ``export.load_exported``
    and held against the eager ``make_infer_fn`` at one seed; its decode
    timed beside ``Synthesizer.infer``'s over the same steps."""
    from gantron_tpu_torch import export
    from gantron_tpu_torch.ops.quant import qmm
    from gantron_tpu_torch.text import text_to_sequence

    path = os.path.join(root, "tts_b1.pt2")
    nbytes, export_s = timed(lambda: synth.export(
        path, batch_size=1, text_len=text_len, max_steps=steps))
    serve, load_s = timed(lambda: export.load_exported(path))
    seq = text_to_sequence(RTF_TEXT, hp.text_cleaners)
    ids, lengths = export.pad_text(seq, text_len), np.array([len(seq)])
    serve(ids, lengths, seed)  # warm-up
    torch.cuda.synchronize()
    qmm.launches = 0  # the exported program's decode starts here
    (mel, out_len), program_s = timed(lambda: serve(ids, lengths, seed))
    launches = qmm.launches  # read just after it
    fn, _ = export.make_infer_fn(synth.model, steps)
    args = [torch.from_numpy(a).to("cuda") for a in (ids, lengths)]
    (ref, ref_len), eager_s = timed(
        lambda: export.seeded_call(fn, seed, "cuda", *args))
    err = (mel - ref).abs().max().item()
    synth.infer(RTF_TEXT, seed=seed, early_exit=False)  # warm-up
    _, infer_s = timed(lambda: synth.infer(RTF_TEXT, seed=seed,
                                           early_exit=False))
    ok = (launches == 4 * steps and err <= 1e-5
          and torch.equal(out_len, ref_len) and bool(torch.isfinite(mel).all())
          and mel.shape == (1, hp.n_mel_channels,
                            steps * hp.n_frames_per_step))
    result = {"steps": steps, "text_len": text_len, "bytes": nbytes,
              "export_s": export_s, "load_s": load_s,
              "program_decode_s": program_s, "eager_fn_s": eager_s,
              "synthesizer_infer_s": infer_s, "max_abs_err_vs_eager": err,
              "tol": 1e-5, "lengths": out_len.tolist(),
              "qmm_launches": launches, "ok": ok}
    log(f"[export] Synthesizer.export (B=1, text_len {text_len}, {steps} "
        f"steps, int8) in {export_s:.2f} s, {nbytes} bytes, loaded in "
        f"{load_s:.2f} s; the loaded program decodes in {program_s:.3f} s "
        f"({launches} qmm launches), Synthesizer.infer over the same steps "
        f"{infer_s:.3f} s; max|program - eager make_infer_fn| {err:.3e} "
        f"(tol 1e-5), lengths {out_len.tolist()} vs {ref_len.tolist()} "
        f"{'ok' if ok else 'FAIL'} [{gpu}]")
    if not ok:
        raise AssertionError("export: the loaded program disagrees with the "
                             "eager function or launched qmm "
                             f"{launches} times for {steps} steps")
    return result


def phase_waveglow_forward(mels, wav, gpu):
    """``WaveGlow.forward`` at the published width on phase 5's B = 8
    waveform, and back through ``infer(sigma=1.0)``, float32 with TF32 off;
    the coupling layers' end convs are drawn non-zero so that every flow
    acts."""
    from gantron_tpu_torch.models.waveglow import (WaveGlow, WaveGlowConfig,
                                                   random_params)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = WaveGlowConfig()
    params = random_params(torch.Generator().manual_seed(5), cfg)
    g = torch.Generator().manual_seed(6)
    for wn in params["wn"]:
        for name in ("end_w", "end_b"):
            wn[name] = 0.02 * torch.randn(wn[name].shape, generator=g)
    wg = WaveGlow(cfg, params, device="cuda")
    z, forward_s = timed(lambda: wg.forward(wav, mels))
    rec, infer_s = timed(lambda: wg.infer(mels, sigma=1.0, z=z))
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults again
    err = (rec - wav).abs().max().item()
    scale = wav.abs().max().item()
    tol = 1e-4 * max(1.0, scale)
    shapes = [tuple(zi.shape[1:]) for zi in z]
    ok = err <= tol and shapes == wg.z_shapes(mels.shape[2]) and all(
        bool(torch.isfinite(zi).all()) for zi in z)
    result = {"wav_shape": list(wav.shape), "forward_s": forward_s,
              "infer_s": infer_s, "max_abs_err": err, "max_abs_wav": scale,
              "tol": tol, "ok": ok}
    log(f"[waveglow-forward] {tuple(wav.shape)} -> {len(z)} latents "
        f"{shapes} in {forward_s:.3f} s, back through infer(sigma=1.0) in "
        f"{infer_s:.3f} s: max|audio - round trip| {err:.3e} (tol "
        f"{tol:.1e}, max|audio| {scale:.3f}) {'ok' if ok else 'FAIL'} "
        f"[{gpu}]")
    if not ok:
        raise AssertionError("WaveGlow.forward: the round trip does not "
                             "give the audio back")
    return result


RTF_CLI_RUNS = {"B=1": [], "B=8": ["--batch", "8"],
                "streaming": ["--streaming"],
                "bfloat16": ["--taco_dtype", "bfloat16"]}


def phase_rtf_cli(gpu, kind):
    """``python -m gantron_tpu_torch.cli.rtf`` as a user runs it, int8
    recurrence matrices on: B = 1, ``--batch 8``, ``--streaming`` and
    ``--taco_dtype bfloat16``; each JSON line parsed and its qmm launches
    held to 4 a decoder step."""
    results = {}
    for label, extra in RTF_CLI_RUNS.items():
        cmd = [sys.executable, "-m", "gantron_tpu_torch.cli.rtf",
               "--hparams", "quantized_inference=True", *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                              timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"cli.rtf {label} exited "
                                 f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        r["process_s"] = wall
        ok = (r["device"] == kind and r["gpu"] and math.isfinite(r["value"])
              and r["value"] > 0
              and r["qmm_launches"] == 4 * r["decoder_steps"] > 0)
        results[label] = r
        extra_s = (f", TTFA {r['ttfa_s']:.3f} s" if "ttfa_s" in r else "")
        log(f"[rtf-cli] {label}: {r['value']:.4f} {r['unit']}, synthesis "
            f"{r['synthesis_s']:.3f} s for {r['audio_s']:.3f} s of audio"
            f"{extra_s}, {r['qmm_launches']} qmm launches for "
            f"{r['decoder_steps']} steps, taco {r['taco_dtype']}; process "
            f"{wall:.1f} s {'ok' if ok else 'FAIL'} [{r['gpu']}]")
        if not ok:
            raise AssertionError(f"cli.rtf {label}: {r}")
    return results


def phase_bench_cli(kind, trials=2, timed_cycles=3, warmup_cycles=1):
    """``cli.bench`` in this process, shortened through its function
    arguments (the full run is ``python -m gantron_tpu_torch.cli.bench``):
    its JSON record, with the FLOPs of one G and one D step and the MFU."""
    from gantron_tpu_torch.cli import bench

    r = bench.main([], trials=trials, timed_cycles=timed_cycles,
                   warmup_cycles=warmup_cycles)
    ok = (r["device"] == kind and r["value"] > 0 and r["flops_per_step"] > 0
          and (r["mfu"] is None or 0 < r["mfu"] < 1))
    log(f"[bench-cli] {r['value']:.4f} steps/s (median of {trials} trials of "
        f"{timed_cycles} G/G/D cycles, spread {r['spread_pct']:.1f}%), "
        f"{r['flops_per_step']:.4e} FLOPs a step (G {r['g_step_flops']:.4e}, "
        f"D {r['d_step_flops']:.4e}), MFU {r['mfu']}, peak memory "
        f"{r['peak_memory_bytes']} bytes {'ok' if ok else 'FAIL'} "
        f"[{r['gpu']}]")
    if not ok:
        raise AssertionError(f"cli.bench: {r}")
    return r


# Phase 21's classifier parity: 64 synthetic dB mels of 5 classes, 2 epochs.
EVAL_CLASSES, EVAL_MELS, EVAL_EPOCHS = 5, 64, 2
# Phase 21's study: groups x samples, each decoded to the cap.
STUDY_GROUPS, STUDY_SAMPLES, STUDY_STEPS = 6, 4, 200


def eval_mels(root, hp, n=EVAL_MELS, seed=0):
    """Class-separable synthetic dB mels (90-149 frames) as .npy, and their
    one-hot labels."""
    rng = np.random.RandomState(seed)
    band = hp.n_mel_channels // EVAL_CLASSES
    paths, labels = [], []
    for i in range(n):
        c = i % EVAL_CLASSES
        mel = rng.randn(hp.n_mel_channels, rng.randint(90, 150)) * 2 - 70
        mel[c * band:(c + 1) * band] += 55
        paths.append(os.path.join(root, f"clf-{i}.npy"))
        np.save(paths[-1], np.clip(mel, -80, 0).astype(np.float32))
        labels.append(np.eye(5, dtype=np.float32)[c])
    return paths, labels


# Phase 21's lockstep tolerances. Gradients: within phase 11's moment_tol
# (``CARD_VS_CPU``) of each tensor's largest for the linear variant; 1e-2
# for the conv variant, whose 3x3 weight gradients are sums that the
# training BatchNorm behind each conv nearly cancels: against float64 on
# the first batch an H100 (700 W) is off by up to 4.2e-3 of the largest
# and the host CPU by up to 1.2e-3 (``gradient_precision`` prints both each
# run). Updated
# parameters: each step's Adam update on the card against the same update
# computed on the CPU from the card's own gradients and moments, within
# phase 11's param_atol, which holds the optimizer's arithmetic apart from
# the gradients' precision.
GRAD_TOL = {True: CARD_VS_CPU["moment_tol"], False: 1e-2}  # by linear_model


def lockstep(trainer, record=None):
    """Wraps ``trainer``'s optimizer. With no ``record`` it keeps each step's
    gradients and updated parameters (CPU copies) in the list it returns.
    With one it holds each step's gradients against the recorded ones and
    its update against the CPU's update of the same gradients and moments
    (``GRAD_TOL``), then continues from the recorded parameters: every step
    starts where the other run's did, so the trajectories cannot drift
    apart. Returns (steps, worst), ``worst`` the largest error of each kind
    as a share of its tolerance."""
    from gantron_tpu_torch.train.state import AdamState, Optimizer

    inner, steps = trainer.tx, []
    worst = {"gradient": 0.0, "update": 0.0}
    names = [n for n, _ in trainer.model.named_parameters()]
    grad_tol = GRAD_TOL[bool(trainer.hp.linear_model)]

    def check(kind, name, err):
        worst[kind] = max(worst[kind], err)
        if not err <= 1:
            raise AssertionError(f"step {len(steps)}: {name} ({kind}) off "
                                 f"by {err:.3g} of its tolerance")

    @torch.no_grad()
    def update(grads, state, params, lr):
        if record is None:
            state = inner.update(grads, state, params, lr)
            steps.append(([g.cpu().clone() for g in grads],
                          [p.detach().cpu().clone() for p in params]))
            return state
        expect = [p.detach().cpu().clone() for p in params]
        inner.update([g.cpu() for g in grads],
                     AdamState(state.count, [m.cpu() for m in state.mu],
                               [v.cpu() for v in state.nu]), expect, lr)
        state = inner.update(grads, state, params, lr)
        r_grads, r_params = record[len(steps)]
        steps.append(None)
        for name, g, rg, p, e, rp in zip(names, grads, r_grads, params,
                                         expect, r_params):
            top = rg.abs().max().item()
            check("gradient", name, (g.cpu() - rg).abs().max().item()
                  / (grad_tol * top) if top else 0.0)
            check("update", name, (p.cpu() - e).abs().max().item()
                  / CARD_VS_CPU["param_atol"])
            p.copy_(rp)
        return state

    trainer.tx = Optimizer(inner.init, update)
    return steps, worst


def first_step_gradients(hp, device, dtype, paths, labels):
    """The weight gradients of the first training batch of
    ``train_classifier``'s run, in ``dtype`` on ``device`` (float64 runs
    the BatchNorms' arithmetic in float32, as the model does)."""
    from gantron_tpu_torch.eval.classifier import ClassifierTrainer, MelCrops
    from gantron_tpu_torch.models.classifier import crop_batch, make_classifier

    model = make_classifier(hp, "cpu", seed=0).to(device, dtype)
    model.train_dropout = False
    trainer = ClassifierTrainer(hp, device=device, model=model)
    mels, lengths, labels = next(MelCrops(
        paths, labels, hp.mel_offset, hp.max_noise, seed=1).batches(
            hp.batch_size, pad_to=hp.n_frames + hp.mel_offset))
    starts = np.random.RandomState(1).randint(
        0, mels.shape[2] - hp.n_frames + 1, len(lengths))
    crops = crop_batch(torch.as_tensor(mels, device=device), lengths,
                       hp.n_frames, hp.mel_offset, starts=starts)
    logits = model(crops, train=True)
    loss = trainer._loss(logits, torch.as_tensor(labels, device=device,
                                                 dtype=dtype))
    named = [(n, p) for n, p in model.named_parameters()
             if n.startswith("layers") and p.dim() > 1]
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return {n: g.detach().cpu().double() for (n, _), g in zip(named, grads)}


def gradient_precision(hp, paths, labels):
    """Each weight gradient of the first batch on the card and on the CPU
    (float32, TF32 off) against float64: the largest error as a share of
    the tensor's largest entry, by device."""
    ref = first_step_gradients(hp, "cpu", torch.float64, paths, labels)
    out = {}
    for device in ("cuda", "cpu"):
        got = first_step_gradients(hp, device, torch.float32, paths, labels)
        out[device] = {n: ((got[n] - r).abs().max()
                           / r.abs().max()).item() for n, r in ref.items()}
    return out


def train_classifier(hp, device, paths, labels, record=None):
    """A classifier from seed 0 trained ``EVAL_EPOCHS`` on ``device``: dropout
    off, crop starts from a fixed numpy stream, the hidden layers' biases
    given their exact gradient (``exact_bn_fed_gradients``), its optimizer
    in ``lockstep`` with ``record``. Returns (trainer, history, seconds,
    steps, worst)."""
    from gantron_tpu_torch.eval.classifier import (ClassifierTrainer,
                                                   MelCrops,
                                                   exact_bn_fed_gradients)
    from gantron_tpu_torch.models.classifier import make_classifier

    rs = np.random.RandomState(1)

    def starts(lengths, T, train):
        return rs.randint(0, T - hp.n_frames + 1, len(lengths))

    model = make_classifier(hp, "cpu", seed=0)
    model.train_dropout = False
    trainer = ClassifierTrainer(hp, device=device, model=model,
                                crop_starts=starts)
    steps, worst = lockstep(trainer, record)  # sees the exact gradients
    exact_bn_fed_gradients(trainer)
    val = EVAL_MELS // 4
    history, seconds = timed_any(lambda: trainer.fit(
        MelCrops(paths, labels, hp.mel_offset, hp.max_noise, seed=1),
        MelCrops(paths[:val], labels[:val], hp.mel_offset, hp.max_noise,
                 seed=2), epochs=EVAL_EPOCHS), device)
    return trainer, history, seconds, steps, worst


def timed_any(fn, device):
    """(fn(), seconds), the card's work finished when ``device`` is one."""
    if torch.device(device).type == "cuda":
        return timed(fn)
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def compare_classifiers(card, cpu, what, tol=1e-4):
    """The lockstep runs' histories within ``tol`` relative, their BatchNorm
    running statistics within ``tol`` and Adam moments within the
    gradients' tolerance (``GRAD_TOL``) of each tensor's largest. Returns
    the worst error of each kind as a share of its tolerance."""
    worst = dict(card[4])
    for a, b in zip(card[1], cpu[1]):
        for k in b:
            if not math.isclose(a[k], b[k], rel_tol=tol, abs_tol=0.0):
                raise AssertionError(f"{what}: {k} {a[k]} on the card, "
                                     f"{b[k]} on the CPU")
    pairs = [(f"buffer {n}", x, y) for (n, x), y in zip(
        card[0].model.named_buffers(), cpu[0].model.buffers())]
    pairs += [(f"Adam moment {i}", x, y) for i, (x, y) in enumerate(zip(
        card[0].opt_state.mu + card[0].opt_state.nu,
        cpu[0].opt_state.mu + cpu[0].opt_state.nu))]
    for name, x, y in pairs:
        x, y = x.cpu().double(), y.double()
        kind = name.split()[0]
        bound = (tol if kind == "buffer"
                 else GRAD_TOL[bool(cpu[0].hp.linear_model)]) \
            * max(y.abs().max().item(), 1e-30)
        err = (x - y).abs().max().item() / bound
        worst[kind] = max(worst.get(kind, 0.0), err)
        if not err <= 1:
            raise AssertionError(f"{what}: {name} off by {err:.3g} of its "
                                 "tolerance")
    return worst


def phase_eval_toolkit(smi, root):
    """Phase 21: the classifier on the card against the CPU, ``study_model``
    on the card, the five evaluation CLIs (docstring)."""
    import importlib.util
    import shutil

    from gantron_tpu_torch.cli import (check_kmeans, clustering,
                                       inference_classifier)
    from gantron_tpu_torch.config import ClassifierHParams, HParams
    from gantron_tpu_torch.data.toy import synth_emotive_utterance
    from gantron_tpu_torch.data.wav import write_wav
    from gantron_tpu_torch.eval.classifier import ClassifierTrainer
    from gantron_tpu_torch.eval.study import study_model
    from gantron_tpu_torch.models.tacotron2 import Tacotron2
    from gantron_tpu_torch.ops.mel import log_mel
    from gantron_tpu_torch.ops.quant import qmm

    result = {"packages": {m: importlib.util.find_spec(m) is not None
                           for m in ("sklearn", "scipy", "matplotlib")}}
    log(f"[eval] installed: {result['packages']}")

    # 21.1 The classifier, card against CPU, both variants at full width.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    chp = ClassifierHParams()
    paths, labels = eval_mels(root, chp)
    result["classifier"] = {}
    for linear in (True, False):
        hp = ClassifierHParams.create(f"linear_model={linear}")
        precision = gradient_precision(hp, paths, labels)
        cpu = train_classifier(hp, "cpu", paths, labels)
        card = train_classifier(hp, "cuda", paths, labels, record=cpu[3])
        name = "linear" if linear else "conv"
        worst = compare_classifiers(card, cpu, f"classifier {name}")
        path = os.path.join(root, f"classifier-{name}.pt")
        card[0].save(path)
        back = ClassifierTrainer.load(path, device="cuda")
        if back.hp != card[0].hp or not all(
                torch.equal(a, b) for a, b in zip(
                    card[0].model.state_dict().values(),
                    back.model.state_dict().values())) or not all(
                torch.equal(a, b) for a, b in zip(
                    card[0].opt_state.mu + card[0].opt_state.nu,
                    back.opt_state.mu + back.opt_state.nu)):
            raise AssertionError(f"classifier {name}: save/load differs")
        h = card[1][-1]
        result["classifier"][name] = {
            "card_s": card[2], "cpu_s": cpu[2], "worst_shares": worst,
            "first_batch_gradient_error_vs_float64": precision,
            "history": card[1]}
        log(f"[eval] classifier {name} (80 mels x 80 frames, model_size "
            f"{hp.model_size}): {EVAL_EPOCHS} epochs on {EVAL_MELS} mels in "
            f"{card[2]:.3f} s on the card, {cpu[2]:.3f} s on the CPU; last "
            f"epoch train loss {h['train_loss']:.6f}, acc {h['train_acc']:.4f},"
            f" val acc {h['val_acc']:.4f}; card vs CPU in lockstep, worst "
            "error as a share of its tolerance: "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
            + "; first batch's weight gradients against float64, worst "
            + ", ".join(f"{d} {max(e.values()):.3g}"
                        for d, e in precision.items())
            + f" of a tensor's largest; save/load bit-equal [{smi}]")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default again

    # 21.2 study_model on the card: phase 5's model, its gate pinned.
    hp = HParams.create("use_noise=True,use_labels=False,"
                        f"quantized_inference=True,"
                        f"max_decoder_steps={STUDY_STEPS}")
    model = Tacotron2(hp, device="cuda", seed=0).eval()
    model.decoder.gate_b.data.fill_(COND_GATE_BIAS)
    out = os.path.join(root, "study")
    stages = {}
    torch.cuda.synchronize()
    qmm.launches = 0  # the study path starts here
    metrics = study_model(out, model, hp, RTF_TEXT, n_groups=STUDY_GROUPS,
                          samples=STUDY_SAMPLES, classifier_epochs=2,
                          seed=0, stage_seconds=stages)
    study_qmm = qmm.launches  # read just after the path
    n = STUDY_GROUPS * STUDY_SAMPLES
    mel_dir = os.path.join(out, "GANtronInference")
    wav_dir = os.path.join(out, "WaveGlowInference")
    wavs = sorted(f for f in os.listdir(wav_dir) if f.endswith(".wav"))
    feats = [f for f in os.listdir(wav_dir) if f.endswith(".npy")]
    numbers = [v for r in metrics["history"] for v in r.values()
               if isinstance(v, float)] + [
        v for k, v in metrics.items() if isinstance(v, float)]
    if len(os.listdir(mel_dir)) != n or len(wavs) != n or len(feats) != n \
            or metrics["generation_error_rate"] != 1.0 \
            or not all(math.isfinite(v) for v in numbers) \
            or study_qmm != 4 * STUDY_STEPS * STUDY_GROUPS:
        raise AssertionError(f"study: {len(wavs)} wavs, {len(feats)} "
                             f"features, {metrics}, {study_qmm} qmm launches")
    result["study"] = {"stage_seconds": stages, "qmm_launches": study_qmm,
                       "metrics": {k: v for k, v in metrics.items()
                                   if k != "history"}}
    log(f"[eval] study_model {STUDY_GROUPS} groups x {STUDY_SAMPLES} "
        f"samples, {STUDY_STEPS} steps, Griffin-Lim, 2 classifier epochs: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
        + f"; generation_error_rate {metrics['generation_error_rate']}, "
        f"test acc {metrics.get('test_acc')}; {study_qmm} qmm launches "
        f"[{smi}]")

    # 21.3 The CLIs: check_kmeans on a dir per emotion of tone wavs.
    corpus = os.path.join(root, "emotions")
    rng = np.random.RandomState(0)
    for emotion in ("Neutral", "Angry", "Sad"):
        os.makedirs(os.path.join(corpus, emotion))
        for i in range(8):
            write_wav(os.path.join(corpus, emotion, f"{i}.wav"),
                      synth_emotive_utterance("ames mist", emotion, 0, rng))
    torch.cuda.synchronize()
    log_mel.launches = 0  # cli.check_kmeans starts here
    km_card, km_s = timed(lambda: check_kmeans.main(
        ["--audio_path", corpus]))
    km_mel = log_mel.launches
    for emotion in ("Neutral", "Angry", "Sad"):  # the CPU featurizes anew
        for f in glob_npy(os.path.join(corpus, emotion)):
            os.remove(f)
    km_cpu = check_kmeans.main(["--audio_path", corpus, "--device", "cpu"])
    if km_mel != 24 or km_card[1] != 1.0 or km_card != km_cpu:
        raise AssertionError(f"check_kmeans: {km_mel} mel launches, card "
                             f"{km_card}, CPU {km_cpu}")
    # clustering --audio on the study's 24 wavs alone.
    only_wavs = os.path.join(root, "study_wavs")
    os.makedirs(only_wavs)
    for f in wavs:
        shutil.copy(os.path.join(wav_dir, f), only_wavs)
    args = ["--path", only_wavs, "--audio", "--check_clusterizations",
            "--classes_items", str(STUDY_SAMPLES)]
    torch.cuda.synchronize()
    log_mel.launches = 0  # cli.clustering starts here
    cl_card, cl_s = timed(lambda: clustering.main(args))
    cl_mel = log_mel.launches
    cl_cpu = clustering.main(args + ["--device", "cpu"])
    pairs = set(zip(cl_card[2].labels_.tolist(), cl_cpu[2].labels_.tolist()))
    if cl_mel != n or len(pairs) != len({a for a, _ in pairs}) \
            or len(pairs) != len({b for _, b in pairs}):
        raise AssertionError(f"clustering: {cl_mel} mel launches; labels on "
                             f"the card {cl_card[2].labels_}, on the CPU "
                             f"{cl_cpu[2].labels_}")
    # inference_classifier with 21.1's linear classifier.
    clf = os.path.join(root, "classifier-linear.pt")
    emotion, inf_s = timed(lambda: inference_classifier.main(
        ["-c", clf, "--path", os.path.join(only_wavs, wavs[0])]))
    folder_acc = inference_classifier.main(
        ["-c", clf, "--path", only_wavs, "--inference_folder", "--dataset",
         "SAVEE"])
    result["clis"] = {
        "check_kmeans": {"result": list(km_card[:2]) + [list(km_card[2])],
                         "mel_launches": km_mel, "s": km_s},
        "clustering": {"accuracy": cl_card[0], "mel_launches": cl_mel,
                       "s": cl_s, "labels_card": cl_card[2].labels_.tolist(),
                       "labels_cpu": cl_cpu[2].labels_.tolist()},
        "inference_classifier": {"emotion": emotion, "s": inf_s,
                                 "folder_accuracy": folder_acc}}
    log(f"[eval] cli.check_kmeans (3 emotions x 8 tone wavs): best "
        f"accuracy {km_card[1]}, basic {km_card[0]}, {km_mel} mel launches, "
        f"{km_s:.3f} s, the CPU's result equal; cli.clustering --audio "
        f"--check_clusterizations ({n} study wavs): accuracy "
        f"{cl_card[0]:.4f}, {cl_mel} mel launches, {cl_s:.3f} s, k-means "
        f"labels equal to the CPU's up to a permutation; "
        f"cli.inference_classifier: {emotion} in {inf_s:.3f} s, folder "
        f"{folder_acc} [{smi}]")
    return result


def glob_npy(d):
    return [os.path.join(d, f) for f in os.listdir(d) if f.endswith(".npy")]


# Phase 22's two configurations of the repo's own identification studies, at
# HParams defaults' widths. A: scripts/gan_composed_study.py "full";
# B: scripts/gan_factorial_study.py "bit2x2_rescue_q" with the three code
# terms, the probe of 8 rows and the diagonal controller's ceiling of its
# _BIT_WARM. identification_warmup is cut from 1000 to 2 and
# factor_rescue_warmup from 2000 to 0, so that the terms and the rescue act
# within six iterations.
IDENT_ARMS = {
    "A": dict(adversarial_rollouts=True, style_reconstruction_weight=10.0,
              diversity_weight=1.0, diversity_cap=0.9, style_code_dims=1,
              style_code_levels=2, gradient_penalty_lambda=10.0,
              identification_warmup=2, validation_sample_diversity=8),
    "B": dict(adversarial_rollouts=True, style_reconstruction_weight=10.0,
              diversity_weight=1.0, diversity_cap=0.9, style_code_dims=2,
              style_code_levels=2, diversity_subset_redraw=True,
              factor_rescue_floor=2.18, factor_rescue_actuator="recon",
              code_modularity_weight=1.0, code_additivity_weight=1.0,
              code_orthogonal_reward=True, validation_sample_diversity=8,
              diversity_rescue_ceiling=8.3, identification_warmup=2,
              factor_rescue_warmup=0),
}
IDENT_CORPUS = {"A": "build_composed_corpus", "B": "build_factorial_corpus"}
# The factor-aware rescue's weights the parity step passes (the recon
# actuator weights the per-dim reconstruction errors by them).
IDENT_DIM_WEIGHTS = {"A": None, "B": [1.0, 4.0]}
# Card against CPU after one float32 G step with rollouts: CARD_VS_CPU, with
# the conv biases before BatchNorm held as every other parameter (the
# rollout's encoder and postnet run on running statistics, which gives them
# a gradient), and every metric within IDENT_METRIC_TOL of max(|v|, 1e-2).
IDENT_CARD_VS_CPU = dict(CARD_VS_CPU, noise_tol=None)
IDENT_METRIC_TOL = 1e-3


def ident_hp(arm, **over):
    from gantron_tpu_torch.config import HParams

    hp = HParams.create("use_noise=True,use_labels=False")
    hp.add_params(dict(IDENT_ARMS[arm], **over))
    return hp


def ident_draws(hp, B, seed, same_code=False):
    """The rollout draws of one G step (``train.step`` g_step's ``draws``)
    on the CPU from ``seed``; ``same_code``: redraws and flips that keep
    the code (an offset of L), so that every decode of the step has the
    first one's code."""
    from gantron_tpu_torch.train.step import (FlipDraws, RedrawDraws,
                                              draw_code)

    g = torch.Generator().manual_seed(seed)
    N, L = hp.noise_size, hp.style_code_levels
    dims = hp.style_code_dims or N
    style = torch.rand((B, 1, N), generator=g)
    style[:, :, :dims] = draw_code(g, (B, 1, dims), L)
    shape = (B, 1, dims)

    def off():
        if same_code:
            return torch.full(shape, L, dtype=torch.long)
        return torch.randint(1, L, shape, generator=g)

    redraw = RedrawDraws(off(), torch.rand(shape, generator=g),
                         torch.randint(0, dims, (B, 1), generator=g),
                         -torch.log(-torch.log(torch.rand(shape, generator=g)
                                               .clamp_min(1e-30))))
    flip = FlipDraws(torch.randint(0, dims, (B,), generator=g),
                     -torch.log(-torch.log(torch.rand((B, dims), generator=g)
                                           .clamp_min(1e-30))),
                     torch.randint(1, max(dims, 2), (B,), generator=g),
                     off(), off())
    return dict(style=style, redraw=redraw, flip=flip)


def draws_to(draws, device):
    def move(x):
        if x is None or torch.is_tensor(x):
            return None if x is None else x.to(device)
        return type(x)(*(move(v) for v in x))
    return {k: move(v) for k, v in draws.items()}


def ident_parity(arm, smi, B=2, T_in=32, T_out=64):
    """(a) One float32 G step of ``arm`` from the same seed on the CPU and
    on the card (dropout off, the gate pinned, the draws injected, TF32
    off); then, dropout on, a step whose decodes all keep the first one's
    code: they decode bit-identically on the card."""
    from gantron_tpu_torch.train.state import compare_states
    from gantron_tpu_torch.train.step import to_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hp = ident_hp(arm)
    batch = train_batch(hp, B, T_in, T_out, seed=3)
    draws = ident_draws(hp, B, seed=4)
    weights = IDENT_DIM_WEIGHTS[arm]
    runs = {}
    for device in ("cpu", "cuda"):
        state, (g_step, _, _) = train_steps(hp, 0, batch, device,
                                            dropout=False)
        state.g_model.decoder.gate_b.data.fill_(COND_GATE_BIAS)
        t0 = time.perf_counter()
        state, m, (mel, lens) = g_step(
            state, to_device(batch, device), G_LR, ATTN_W, 1.0,
            None if weights is None else torch.tensor(weights),
            style=draws["style"].to(device), draws=draws_to(draws, device))
        if device == "cuda":
            torch.cuda.synchronize()
        runs[device] = {"s": time.perf_counter() - t0, "state": state,
                        "metrics": {k: float(v) for k, v in m.items()},
                        "lengths": lens.cpu().tolist()}
    cpu, gpu = runs["cpu"], runs["cuda"]
    worst = {k: abs(gpu["metrics"][k] - v) / max(abs(v), 1e-2)
             for k, v in cpu["metrics"].items()}
    bad = {k: e for k, e in worst.items() if not e <= IDENT_METRIC_TOL}
    if bad or gpu["lengths"] != cpu["lengths"]:
        raise AssertionError(f"identification parity, arm {arm}: metrics "
                             f"{bad}, lengths {gpu['lengths']} vs "
                             f"{cpu['lengths']}")
    shares = compare_states(gpu["state"], cpu["state"],
                            what=f"identification parity, arm {arm}",
                            **IDENT_CARD_VS_CPU)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default again

    # Dropout on: every decode of the step with the first one's code.
    state, (g_step, _, _) = train_steps(hp, 0, batch, "cuda")
    G = state.g_model
    captured, real_rollout = [], G.rollout

    def rollout(*args, **kwargs):
        out = real_rollout(*args, **kwargs)
        captured.append(out[1].detach().clone())
        return out

    G.rollout = rollout
    same = draws_to(ident_draws(hp, B, seed=5, same_code=True), "cuda")
    g_step(state, to_device(batch, "cuda"), G_LR, ATTN_W, style=None,
           draws=same)
    del G.rollout
    identical = len(captured) >= 2 and all(torch.equal(captured[0], c)
                                           for c in captured[1:])
    if not identical:
        raise AssertionError(f"identification, arm {arm}: a same-code "
                             f"decode differs on the card ({len(captured)} "
                             "decodes)")
    result = {"cpu_s": cpu["s"], "card_s": gpu["s"],
              "metrics_rel_err": worst, "metrics": gpu["metrics"],
              "lengths": gpu["lengths"], "same_code_decodes": len(captured),
              "same_code_bit_identical": identical,
              **{k: v for k, v in shares.items()}}
    log(f"[ident-{arm}] (a) one float32 G step, B={B}, T_out {T_out}: CPU "
        f"{cpu['s']:.2f} s, card {gpu['s']:.2f} s; worst metric error "
        f"{max(worst.values()):.2e}; worst share of the tolerance: "
        + "; ".join(f"{k} {shares[k][0]:.3f} ({shares[k][1]})"
                    for k in ("first_moment", "second_moment", "param",
                              "stats"))
        + f"; {len(captured)} same-code decodes bit-identical on the card "
        f"[{smi}]")
    return result


def ident_loop(arm, smi, root, n_train=16, n_val=8, B=8, probe_steps=100):
    """(b) ``train.loop.train`` of ``arm`` for 6 iterations at batch 8
    (fp16_run; all G steps, the warm-up's first 2 without the terms) with one
    validation at 6, its probe cut to ``probe_steps``; then one synced G
    step with the terms and one without them (the vanilla step of the same
    models) on a training batch."""
    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.data import toy
    from gantron_tpu_torch.data.dataset import DataLoader, TextMelDataset
    from gantron_tpu_torch.ops.mel import log_mel
    from gantron_tpu_torch.ops.quant import qmm
    from gantron_tpu_torch.train import loop
    from gantron_tpu_torch.models.tacotron2 import Tacotron2
    from gantron_tpu_torch.train.state import make_optimizer, wrap_models
    from gantron_tpu_torch.train.step import make_train_steps, to_device
    from gantron_tpu_torch.utils.logging import MetricLogger

    n_utts = n_train + n_val
    wav_dir, train_list, val_list, _ = getattr(toy, IDENT_CORPUS[arm])(
        os.path.join(root, f"corpus{arm}"), n_utts=n_utts, n_train=n_train)
    hp = ident_hp(arm, fp16_run=True, batch_size=B, iterations=6,
                  iters_per_checkpoint=6, max_decoder_steps=probe_steps,
                  validation_audio=False, training_files=[train_list],
                  validation_files=[val_list])
    probe_s = []
    real_probe = loop._make_diversity_probe

    def timed_probe(hp_, val_loader):
        probe = real_probe(hp_, val_loader)

        def run(state, it):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = probe(state, it)
            torch.cuda.synchronize()
            probe_s.append(time.perf_counter() - t0)
            return out
        return run

    out = os.path.join(root, f"run{arm}")
    loop._make_diversity_probe = timed_probe
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        log_mel.launches = qmm.launches = 0  # the training loop starts here
        t0 = time.perf_counter()
        state, it = loop.train(out, None, False, hp, wav_dir,
                               logger=MetricLogger(out, run_name="m",
                                                   quiet=True),
                               device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mel_launches, qmm_launches = log_mel.launches, qmm.launches
    finally:
        loop._make_diversity_probe = real_probe
    peak = torch.cuda.max_memory_allocated()
    metrics = read_metrics(os.path.join(out, "m.metrics.jsonl"))
    g_s = [metrics[s]["Generation duration"] for s in range(6)]
    ident = ["Style reconstruction loss" in metrics[s] for s in range(6)]
    values = {k: v for k, v in metrics[6].items()
              if k.startswith(("Identification", "Factor", "Sample"))}
    trained = {k: v.detach().clone()
               for k, v in state.g_model.state_dict().items()}
    finite = all(np.isfinite(v) for m in metrics.values()
                 for k, v in m.items() if isinstance(v, float))
    if not (it == 6 == state.step and all(ident) and finite
            and mel_launches == n_utts and qmm_launches == 0
            and len(probe_s) == 1 and "Sample diversity" in values):
        raise AssertionError(
            f"identification loop, arm {arm}: iterations {it}, step "
            f"{state.step}, identification metrics {ident}, finite {finite},"
            f" mel launches {mel_launches} for {n_utts} wavs, qmm "
            f"{qmm_launches}, probes {len(probe_s)}, values {values}")
    if arm == "B" and not {"Identification separation",
                           "Identification rescue scale",
                           "Factor rescue scale dim1"} <= set(values):
        raise AssertionError(f"identification loop, arm B: {values}")

    # Synced step times on one training batch: with the terms (this arm's
    # step) and without them (the vanilla step of the same weights, on a
    # generator without the style encoder, which the vanilla loss leaves
    # out of its graph).
    dataset = TextMelDataset([train_list], hp, wav_dir, device="cuda")
    batch = to_device(next(iter(DataLoader(dataset, hp, batch_size=B))),
                      "cuda")
    vanilla = HParams.create("use_noise=True,use_labels=False,fp16_run=True")
    vanilla_g = Tacotron2(vanilla, device="cuda")
    vanilla_g.load_state_dict({k: v for k, v in trained.items()
                               if not k.startswith("style_encoder.")})
    vanilla_state = wrap_models(vanilla, vanilla_g, state.d_model, hp.seed)[0]
    step_s = {}
    for name, h, st in (("identification", hp, state),
                        ("vanilla", vanilla, vanilla_state)):
        g_tx = make_optimizer(h.grad_clip_thresh, h.weight_decay)
        g_step, _, _ = make_train_steps(h, st.g_model, st.d_model, g_tx,
                                        g_tx)
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st, _, _ = g_step(st, batch, G_LR, ATTN_W)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        step_s[name] = times
    result = {"arm": arm, "hparams": dict(IDENT_ARMS[arm]),
              "corpus": IDENT_CORPUS[arm], "utterances": n_utts,
              "T_out": int(batch.mels.shape[2]), "iterations": it,
              "wall_s": wall, "g_step_logged_s": g_s,
              "warmup_g_step_logged_s": g_s[:2],
              "probe_s": probe_s, "probe_steps": probe_steps,
              "validation_values": values, "peak_memory_bytes": peak,
              "mel_launches": mel_launches, "qmm_launches": qmm_launches,
              "synced_g_step_s": step_s}
    log(f"[ident-{arm}] (b) train() 6 iterations at B={B} on "
        f"{IDENT_CORPUS[arm]} ({n_utts} wavs, T_out {result['T_out']}): "
        f"{wall:.2f} s; G steps as the loop logs them (host issue time) "
        f"{', '.join(f'{s:.2f}' for s in g_s)} s (the first 2 in the "
        f"identification warm-up); synced G step with the identification "
        f"terms {min(step_s['identification']):.3f} s, without them "
        f"(vanilla, same models and batch) {min(step_s['vanilla']):.3f} s; "
        f"probe ({probe_steps} steps) {probe_s[0]:.2f} s; "
        + ", ".join(f"{k} {v:.4g}" for k, v in values.items())
        + f"; peak memory {peak / 2**30:.2f} GiB; mel launches "
        f"{mel_launches}, qmm {qmm_launches} [{smi}]")
    return result, trained


def ident_bench(smi, train_bench, B=32, T_in=128, T_out=640):
    """(c) Arm A's rollout G step at bench.py's shape (fp16_run): a first
    step and a timed second one, and the peak memory of both."""
    from gantron_tpu_torch.train.step import to_device

    hp = ident_hp("A", fp16_run=True)
    batch = to_device(train_batch(hp, B, T_in, T_out, seed=0), "cuda")
    state, (g_step, _, _) = train_steps(hp, 0, batch, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        state, m, _ = g_step(state, batch, G_LR, ATTN_W)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    metrics = {k: float(v) for k, v in m.items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"rollout G step at the bench shape: {metrics}")
    vanilla_s = min(train_bench["g_step_s"])
    result = {"B": B, "T_in": T_in, "T_out": T_out, "g_step_s": times,
              "peak_memory_bytes": peak, "metrics": metrics,
              "vanilla_g_step_s": vanilla_s,
              "vanilla_peak_memory_bytes": train_bench["peak_memory_bytes"]}
    log(f"[ident-A] (c) rollout G step at B={B}, T_in {T_in}, T_out {T_out}"
        f" ({T_out} rollout steps, two decodes): first {times[0]:.2f} s, "
        f"second {times[1]:.2f} s; peak memory {peak / 2**30:.2f} GiB; "
        f"phase 13's vanilla G step {vanilla_s:.3f} s, peak "
        f"{train_bench['peak_memory_bytes'] / 2**30:.2f} GiB [{smi}]")
    return result


def phase_identification(smi, root, train_bench):
    """Phase 22: the identification machinery at full width, arms A and B:
    (a) card against CPU, (b) the training loop, (c) arm A at the bench
    shape, (d) launches: qmm 0 in the training steps, mel one a wav."""
    results = {arm: {"parity": ident_parity(arm, smi)} for arm in "AB"}
    trained = {}
    for arm in "AB":
        results[arm]["loop"], trained[arm] = ident_loop(arm, smi, root)
    results["A"]["bench_shape"] = ident_bench(smi, train_bench)
    return results, trained["A"]


def phase_calibration(smi, root, trained, n_utts=28, n_draws=8, steps=200):
    """Phase 23: the leveled corpus's real levels and anchors on the card
    (mel one a wav), arm A's trained generator copied to int8,
    ``measure_knob`` (11 codes x ``n_draws`` draws in one decode of
    ``steps`` steps, the gate pinned), ``KnobCalibration`` with a JSON round
    trip, ``infer_mel(level=)`` at B = 1 and B = 4, and qmm against its
    plain version at this path's batch sizes. ``trained``: arm A's generator
    after phase 22 (a state dict)."""
    from gantron_tpu_torch.data import toy
    from gantron_tpu_torch.eval import mode_study
    from gantron_tpu_torch.eval.calibration import (KnobCalibration,
                                                    measure_knob)
    from gantron_tpu_torch.models.tacotron2 import Tacotron2
    from gantron_tpu_torch.ops.mel import log_mel
    from gantron_tpu_torch.ops.quant import dequantize, qmatmul, qmm
    from gantron_tpu_torch.text import text_to_sequence
    from gantron_tpu_torch.tts import Synthesizer

    hp = ident_hp("A", quantized_inference=True, max_decoder_steps=steps)
    wav_dir, train_list, _, levels = toy.build_leveled_corpus(
        os.path.join(root, "leveled"), n_utts=n_utts, n_train=n_utts)
    band = mode_study.band_channels(hp, *toy.MODEBAND_SCORE)
    torch.cuda.synchronize()
    log_mel.launches = 0  # the mode study starts here
    t0 = time.perf_counter()
    real = mode_study.compute_real_levels(train_list, wav_dir, levels, hp,
                                          band, device="cuda")
    modes = {n: int(u > 0.5) for n, u in levels.items()}
    anchors = mode_study.compute_real_anchors(train_list, wav_dir, modes, hp,
                                              band, device="cuda")
    mode_s = time.perf_counter() - t0
    mel_launches = log_mel.launches
    if not (mel_launches == n_utts and real["n"] == n_utts
            and real["spearman"] > 0.9 and anchors["mode_hi"]
            > anchors["mode_lo"]):
        raise AssertionError(f"mode study: {mel_launches} mel launches for "
                             f"{n_utts} wavs, {real}, {anchors}")

    model = Tacotron2(hp, device="cuda")
    model.load_state_dict(trained)
    model.decoder.gate_b.data.fill_(COND_GATE_BIAS)
    model.eval()
    ids = np.asarray(text_to_sequence(RTF_TEXT, hp.text_cleaners), np.int64)
    score = lambda m: mode_study.hiband_level(m, band)  # noqa: E731
    torch.cuda.synchronize()
    qmm.launches = 0  # the knob's sweep starts here
    t0 = time.perf_counter()
    codes, lv = measure_knob(model, hp, ids, score, n_draws=n_draws,
                             max_steps=steps)
    knob_s = time.perf_counter() - t0
    sweep_launches = qmm.launches
    curve = KnobCalibration.fit(codes, lv)
    back = KnobCalibration.from_json(curve.to_json())
    if not (np.isfinite(lv).all() and lv.shape == (11, n_draws)
            and back.to_json() == curve.to_json()
            and sweep_launches == 4 * steps):
        raise AssertionError(f"knob: levels {lv.shape}, finite "
                             f"{np.isfinite(lv).all()}, qmm {sweep_launches}")
    synth = Synthesizer(hp, model, device="cuda").load_calibration(
        json.dumps({"calibration": json.loads(curve.to_json())}))
    target = float(np.mean(curve.level_range))
    serve = {}
    for name, text in (("B=1", RTF_TEXT),
                       ("B=4", pad_ids(BATCH_TEXTS[:4], hp.text_cleaners))):
        torch.cuda.synchronize()
        qmm.launches = 0  # the calibrated request starts here
        t0 = time.perf_counter()
        out = synth.infer_mel(text, level=target, seed=1)
        torch.cuda.synchronize()
        out = out if isinstance(out, list) else [out]
        serve[name] = {"s": time.perf_counter() - t0,
                       "qmm_launches": qmm.launches,
                       "lengths": [L for _, L in out],
                       "finite": all(bool(torch.isfinite(m).all())
                                     for m, _ in out)}
        if not (serve[name]["finite"] and qmm.launches == 4 * steps):
            raise AssertionError(f"infer_mel(level=) {name}: {serve[name]}")
    # qmm against its plain version at this path's shapes (not counted).
    W = model.decoder._scan_weights(quantize=True)
    mats = [W.wc, W.wh1, W.w2ih, W.w2hh]
    rng = np.random.RandomState(7)
    checks, timing = [], {}
    for B in (11 * n_draws, 4):
        xs = [torch.from_numpy(rng.normal(0, 1, (B, m.q.shape[0])).astype(
            np.float32)).cuda() for m in mats]
        for x, m in zip(xs, mats):
            y, ref = qmm(x, m), qmatmul(x, m)
            err = (y - ref).abs().max().item()
            ok = torch.allclose(y, ref, **TOL[torch.float32])
            checks.append({"B": B, "I": m.q.shape[0], "O": m.q.shape[1],
                           "max_abs_err": err, "ok": ok})
            if not ok:
                raise AssertionError(f"qmm at B={B}: {err}")
        pairs = list(zip(xs, mats))
        w_deq = [dequantize(m, torch.float32) for m in mats]
        shapes = [(B, m.q.shape[0], m.q.shape[1]) for m in mats]
        bound_ms, bound_by = qmm_bound(shapes, torch.float32)
        timing[B] = {
            "ms": device_ms(lambda: [qmm(x, m) for x, m in pairs]),
            "plain_ms": device_ms(lambda: [qmatmul(x, m) for x, m in pairs]),
            "library_ms": device_ms(lambda: [x @ w for x, w in
                                             zip(xs, w_deq)]),
            "bound_ms": bound_ms, "bound_by": bound_by}
    result = {"real_levels": {k: real[k] for k in
                              ("n", "spearman", "p5", "p95")},
              "anchors": anchors, "mode_study_s": mode_s,
              "mel_launches": mel_launches, "knob_s": knob_s,
              "knob_rows": 11 * n_draws, "knob_steps": steps,
              "knob_qmm_launches": sweep_launches,
              "calibration": json.loads(curve.to_json()),
              "coverage": curve.coverage(real["p5"], real["p95"]),
              "target_level": target, "serve": serve,
              "qmm_checks": checks, "qmm_timing": timing}
    log(f"[calibration] mode study: {n_utts} leveled wavs featurized on the "
        f"card ({mel_launches} mel launches) in {mode_s:.2f} s, real Spearman"
        f" {real['spearman']:.3f}, p5-p95 {real['p5']:.3f}-{real['p95']:.3f};"
        f" knob sweep (11 codes x {n_draws} draws, {steps} steps, int8): "
        f"{knob_s:.2f} s, qmm {sweep_launches}, sign {curve.sign}, level "
        f"range {curve.level_range[0]:.3f}-{curve.level_range[1]:.3f} "
        f"(coverage {result['coverage']:.3f} of the real range); "
        + "; ".join(f"infer_mel(level={target:.3f}) {k}: {v['s']:.2f} s, "
                    f"qmm {v['qmm_launches']}" for k, v in serve.items())
        + f" [{smi}]")
    for B, t in timing.items():
        err = max(c["max_abs_err"] for c in checks if c["B"] == B)
        log(f"[calibration] qmm, one step's four products at B={B}: kernel "
            f"{t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
            f"x @ w_deq {t['library_ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}); worst "
            f"|kernel - plain| {err:.2e}")
    return result


# Phase 24: data parallel on the card. (a) holds two gloo ranks' G and D
# step against one process at test_torch_train.py's assert_states_match
# tolerances (DP_STATE_TOL), with the moments' doubled (DP_PARITY_TOL): at
# full width the one-process step disagrees with itself by 1.54-1.59 times
# the base moment tolerance when the batch's rows are reordered (the first
# moments of the convs before a training BatchNorm, whose weight gradients
# the normalization nearly cancels; H100 80GB HBM3, PERF.md §6), and the
# ranks sum the same rows in another order. The phase holds the reordered
# one-process steps (``ROW_ORDERS``) within DP_PARITY_TOL too, so the bound
# is the card's own float32 spread, not the ranks'. (b) and (c) drive
# cli/train.py; (c) is held at DP_STATE_TOL. An entry whose second
# moment's root is under 100 Adam eps (1e-6) takes an Adam step of about
# lr * g / (|g| + eps), which float32 rounding of g moves by a large share
# of lr: it is held through its moments (``root_floor``), however large its
# tensor's largest (tests/test_torch_classifier.py holds such entries the
# same way).
DP_STATE_TOL = dict(moment_tol=1e-5, param_rtol=1e-5, param_atol=1e-6,
                    floor=1e-4, noise_tol=1e-6, stats_tol=1e-6,
                    root_floor=1e-6)
DP_PARITY_TOL = dict(DP_STATE_TOL, moment_tol=2e-5)
DP_HPARAMS = ("use_noise=True,use_labels=False,batch_size=8,"
              "iters_per_checkpoint=6,disc_warmp_up=8")
DP_WORKER_TIMEOUT = 600


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_parity_inputs():
    """HParams defaults + use_noise, float32; a global batch of 4 (2 a
    rank) and its style."""
    from gantron_tpu_torch.config import HParams

    hp = HParams.create("use_noise=True,use_labels=False")
    batch = train_batch(hp, 4, 32, 64, seed=1)
    style = torch.from_numpy(np.random.RandomState(2).rand(
        4, 1, hp.noise_size).astype(np.float32))
    return hp, batch, style


def dp_step(hp, batch, style, device="cuda"):
    """One G and one D step of a fresh state (seed 0, dropout off) on
    ``batch``; returns (state, metrics)."""
    from gantron_tpu_torch.train.step import to_device

    state, (g_step, d_step, _) = train_steps(hp, 0, batch, device,
                                             dropout=False)
    b = to_device(batch, device)
    state, gm, (mel, lens) = g_step(state, b, G_LR, ATTN_W,
                                    style=style.to(device))
    state, dm = d_step(state, b.mels, b.output_lengths, mel, lens, D_LR)
    return state, {k: float(v) for k, v in {**gm, **dm}.items()}


def state_digest(state):
    """sha256 of every parameter, buffer and Adam moment of ``state``."""
    import hashlib

    from gantron_tpu_torch.parallel.mesh import state_tensors

    h = hashlib.sha256()
    for t in state_tensors(state):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.digest()


def dp_worker(kind, *argv):
    """One process of phase 24 (``chip_smoke.py --worker KIND ...``)."""
    from gantron_tpu_torch.cli import train as train_cli
    from gantron_tpu_torch.ops.mel import log_mel
    from gantron_tpu_torch.ops.quant import qmm
    from gantron_tpu_torch.parallel import distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if kind == "parity":  # RANK PORT OUT
        from gantron_tpu_torch.parallel.mesh import shard_batch
        from gantron_tpu_torch.train.checkpoint import state_payload

        rank, port, out = int(argv[0]), int(argv[1]), argv[2]
        distributed.initialize_multihost(f"localhost:{port}", 2, rank,
                                         backend="gloo", timeout_s=300)
        hp, batch, style = dp_parity_inputs()
        state, metrics = dp_step(hp, shard_batch(batch, rank, 2), style)
        torch.save(state_payload(state), os.path.join(out, f"rank{rank}.pt"))
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(metrics, f)
        distributed.shutdown()
        return 0
    # "cli" (2 ranks over gloo: RANK PORT OUT ARGS...) or "nccl" (torchrun,
    # world size 1: OUT ARGS...): cli/train.py's main, run to each of the
    # iteration counts that ARGS end with.
    if kind == "cli":
        rank, port, out = int(argv[0]), int(argv[1]), argv[2]
        args, counts = list(argv[3:-2]), argv[-2:]
        args += ["--n_gpus", "2", "--rank", str(rank), "--group_name",
                 "chip_smoke", "--hparams",
                 f"{DP_HPARAMS},fp16_run=True,mesh_shape=[2],"
                 f"dist_backend=gloo,dist_url=tcp://localhost:{port}"]
    else:
        rank, out = int(os.environ["RANK"]), argv[0]
        args, counts = list(argv[1:-2]), argv[-2:]
        # Deterministic convolutions, as in the run (c) is held against.
        torch.backends.cudnn.deterministic = True
        args += ["--hparams", f"{DP_HPARAMS},mesh_shape=[1],"
                 "dist_backend=nccl"]
    results = []
    for n in counts:
        log_mel.launches = qmm.launches = 0  # this run starts here
        t0 = time.perf_counter()
        state, it = train_cli.main(
            args[:-1] + [args[-1] + f",iterations={n}"])
        torch.cuda.synchronize()
        digest = torch.tensor(list(state_digest(state)), dtype=torch.uint8,
                              device=state.g_model.device)  # NCCL: no CPU
        chief = digest.clone()
        distributed.broadcast_([chief])
        results.append({
            "iteration": it, "step": state.step,
            "wall_s": time.perf_counter() - t0,
            "mel_launches": log_mel.launches, "qmm_launches": qmm.launches,
            "same_as_chief": bool(torch.equal(digest, chief)),
            "group": [distributed.process_count(),
                      torch.distributed.get_backend()]})
        if kind == "nccl" and len(results) == 1:  # the first G step's state
            import glob
            import shutil

            shutil.copy(glob.glob(os.path.join(
                args[args.index("-o") + 1], "iter=1_*.ckpt"))[0],
                os.path.join(out, "nccl_iter1.ckpt"))
    with open(os.path.join(out, f"{kind}{rank}.json"), "w") as f:
        json.dump(results, f)
    distributed.shutdown()
    return 0


def worker_env():
    """This process's environment without a launcher's rank variables, for
    the processes that the phase starts."""
    return {k: v for k, v in os.environ.items()
            if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}


def run_workers(cmds, cwd, what, meanwhile=None):
    """Runs the commands at once and ``meanwhile()`` in this process while
    they work; waits for each (DP_WORKER_TIMEOUT), killing the rest on the
    way out, and raises with a failed one's output. Returns what
    ``meanwhile`` returned."""
    procs = [subprocess.Popen(c, cwd=cwd, env=worker_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        result = meanwhile() if meanwhile is not None else None
        for p in procs:
            outs.append(p.communicate(timeout=DP_WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"data parallel, {what}: a process exited "
                                 f"{p.returncode}:\n{out[-6000:]}")
    return result


def raw_share(worst, tol, kind):
    """compare_states' worst share under ``tol``, as a share of
    DP_STATE_TOL's tolerance of that kind."""
    if kind == "bn_fed_bias_noise":  # reported as the noise itself
        return worst[kind] / DP_STATE_TOL["noise_tol"]
    key = {"first_moment": "moment_tol", "second_moment": "moment_tol",
           "param": "param_rtol", "stats": "stats_tol"}[kind]
    return worst[kind][0] * tol[key] / DP_STATE_TOL[key]


# Row orders of phase 24 (a)'s batch that give the same step: reversed,
# and its two halves (the ranks' rows) swapped.
ROW_ORDERS = ([3, 2, 1, 0], [2, 3, 0, 1])


def reordered_rows(batch, style, order):
    from gantron_tpu_torch.train.step import Batch

    return (Batch(*(np.ascontiguousarray(x[order]) for x in batch)),
            style[order])


def restored_state(hp, batch, path):
    from gantron_tpu_torch.train.checkpoint import CheckpointManager

    state = train_steps(hp, 0, batch, "cuda", dropout=False)[0]
    return CheckpointManager(os.path.dirname(path)).restore(path, state)


def phase_data_parallel(smi, root, loop_s_per_iteration, n_utts=16):
    """(a) two gloo ranks on the card against one process, (b) the train
    CLI on two ranks with a resume, (c) NCCL at world size 1 through
    torchrun against the run without a group."""
    from gantron_tpu_torch.cli import train as train_cli
    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.data import toy
    from gantron_tpu_torch.train.state import compare_states

    me = [sys.executable, os.path.abspath(__file__), "--worker"]
    checks, t_phase = {}, time.perf_counter()

    def check(name, ok, detail):
        checks[name] = bool(ok)
        if not ok:
            raise AssertionError(f"data parallel: {name}: {detail}")

    # (a) Parity: the ranks run while this process takes the same step on
    # the whole batch, and on its rows reordered.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = os.path.join(root, "parity")
    os.makedirs(out)
    port = free_port()
    hp, batch, style = dp_parity_inputs()

    def one_process():
        return (dp_step(hp, batch, style),
                [dp_step(hp, *reordered_rows(batch, style, o))[0]
                 for o in ROW_ORDERS])

    t0 = time.perf_counter()
    (one, one_metrics), reordered = run_workers(
        [me + ["parity", str(r), str(port), out] for r in (0, 1)], None,
        "2 gloo ranks", meanwhile=one_process)
    parity_s = time.perf_counter() - t0
    ranks = [restored_state(hp, batch, os.path.join(out, f"rank{r}.pt"))
             for r in (0, 1)]
    metrics = [json.load(open(os.path.join(out, f"rank{r}.json")))
               for r in (0, 1)]
    kinds = ("first_moment", "second_moment", "param", "stats",
             "bn_fed_bias_noise")
    spread = {}
    for order, state in zip(ROW_ORDERS, reordered):
        w = compare_states(state, one, what=f"data parallel, one process, "
                           f"rows {order}", **DP_PARITY_TOL)
        spread = {k: max(raw_share(w, DP_PARITY_TOL, k), spread.get(k, 0.0))
                  for k in kinds}
    worst = compare_states(ranks[0], one, what="data parallel, 2 gloo ranks "
                           "vs one process", **DP_PARITY_TOL)
    compare_states(ranks[1], one, what="data parallel, rank 1 vs one "
                   "process", **DP_PARITY_TOL)
    check("ranks bit-equal (states and metrics)",
          state_digest(ranks[0]) == state_digest(ranks[1])
          and metrics[0] == metrics[1], metrics)
    rel = {k: abs(metrics[0][k] - v) / max(abs(v), 1e-6)
           for k, v in one_metrics.items()}
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults again
    log(f"[data-parallel] (a) 2 gloo ranks x B=2 vs one process x B=4, "
        f"full width, float32, TF32 off: {parity_s:.2f} s; in shares of "
        "assert_states_match's tolerances (the moments held at 2x): the "
        "card's own spread (the rows reordered) "
        + "; ".join(f"{k} {v:.3f}" for k, v in spread.items())
        + "; the ranks' worst "
        + "; ".join(f"{k} {raw_share(worst, DP_PARITY_TOL, k):.3f} "
                    f"({worst[k][1]})" for k in kinds[:4])
        + f"; worst metric error {max(rel.values()):.2e} relative "
        f"({max(rel, key=rel.get)}) [{smi}]")

    # (b) The train CLI on two ranks sharing the card (gloo), each rank with
    # its own output directory: only the chief's holds anything.
    corpus = os.path.join(root, "corpus")
    wav_dir, train_list, val_list = toy.build_corpus(
        corpus, n_utts=n_utts, n_train=n_utts // 2, min_chars=20,
        max_chars=141, seed=3)
    os.makedirs(os.path.join(corpus, "filelists"))
    # The CLI reads HParams' default filelists, relative to its directory.
    for src, name in ((train_list, "ljs_audio_text_train_filelist.txt"),
                      (val_list, "ljs_audio_text_val_filelist.txt")):
        os.replace(src, os.path.join(corpus, "filelists", name))
    runs = {r: os.path.join(root, f"run{r}") for r in (0, 1)}
    port = free_port()
    t0 = time.perf_counter()
    run_workers([me + ["cli", str(r), str(port), root, "--wavs_path",
                       wav_dir, "-o", runs[r], "--device", "cuda",
                       "6", "8"] for r in (0, 1)], corpus,
                "cli/train.py on 2 ranks")
    cli_s = time.perf_counter() - t0
    res = [json.load(open(os.path.join(root, f"cli{r}.json")))
           for r in (0, 1)]
    check("iterations", [[x["iteration"] for x in r] for r in res]
          == [[6, 8]] * 2 and [[x["step"] for x in r] for r in res]
          == [[6, 8]] * 2, res)
    check("group", all(x["group"] == [2, "gloo"] for r in res for x in r),
          res)
    check("parameters bit-equal to the chief's (broadcast checksum)",
          all(x["same_as_chief"] for r in res for x in r), res)
    chief_files = sorted(os.listdir(runs[0]))
    ckpts = [n for n in chief_files if n.endswith(".ckpt")]
    check("the chief wrote checkpoints and metrics",
          ckpts and any(n.endswith(".metrics.jsonl") for n in chief_files),
          chief_files)
    check("rank 1 wrote nothing", not os.path.exists(runs[1]),
          os.listdir(runs[1]) if os.path.exists(runs[1]) else None)
    mel_first = [r[0]["mel_launches"] for r in res]
    check("mel launches (cold cache over the ranks, then warm)",
          n_utts <= sum(mel_first) and max(mel_first) <= n_utts
          and all(r[1]["mel_launches"] == 0 for r in res),
          [[x["mel_launches"] for x in r] for r in res])
    qmm_dp = sum(x["qmm_launches"] for r in res for x in r)
    check("qmm launches (never quantized, no probe)", qmm_dp == 0, qmm_dp)
    cache = [n for n in os.listdir(wav_dir) if n.endswith(".mel.npy")]
    stray = [n for n in os.listdir(wav_dir) if n.endswith(".tmp")]
    loads = all(np.load(os.path.join(wav_dir, n)).shape[0] == 80
                for n in cache)
    check("one whole cache file a wav", len(cache) == n_utts and not stray
          and loads, (cache, stray))
    m = read_metrics(glob_one(runs[0], ".metrics.jsonl"))
    step_s = [r["Data duration"] + r.get("Generation duration", r.get(
        "Discriminator duration")) for r in m.values() if "Data duration" in r]
    dp_s_it = float(np.median(step_s))
    seq = "".join("D" if "Discriminator loss" in m[k] else "G"
                  for k in sorted(m) if "Generator loss" in m[k]
                  or "Discriminator loss" in m[k])
    log(f"[data-parallel] (b) cli/train.py on 2 gloo ranks sharing the card, "
        f"global B=8 (4 a rank), fp16_run, {n_utts // 2} + {n_utts // 2} tone "
        f"wavs (one batch each) with a "
        f"cold cache: 6 iterations then resumed to 8 ({seq}) in "
        f"{cli_s:.2f} s with both processes; median {dp_s_it:.3f} s an "
        f"iteration against phase 14's {loop_s_per_iteration:.3f} s (one "
        f"process, B=8); mel launches {mel_first} (then 0), qmm 0; chief's "
        f"checkpoints {ckpts} [{smi}]")

    # (c) NCCL at world size 1 through torchrun against no group: the first
    # G step's checkpoint, then a resume to 2; both with deterministic
    # cuDNN, so that they differ by the group's path alone.
    ref_out, nccl_out = (os.path.join(root, n) for n in ("ref", "nccl"))
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    run_workers([[sys.executable, "-m", "torch.distributed.run",
                  "--nproc_per_node=1", f"--master_port={free_port()}",
                  os.path.abspath(__file__), "--worker", "nccl", root,
                  "--wavs_path", wav_dir, "-o", nccl_out, "--device", "cuda",
                  "1", "2"]], corpus, "torchrun, NCCL")
    nccl_s = time.perf_counter() - t0
    cwd = os.getcwd()
    os.chdir(corpus)
    torch.backends.cudnn.deterministic = True
    try:
        train_cli.main(["--wavs_path", wav_dir, "-o", ref_out, "--device",
                        "cuda", "--hparams",
                        f"{DP_HPARAMS},mesh_shape=[1],iterations=1"])
    finally:
        os.chdir(cwd)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.deterministic = False
    res_c = json.load(open(os.path.join(root, "nccl0.json")))
    check("NCCL group of 1, iterations 1 then 2",
          [(x["iteration"], x["group"]) for x in res_c]
          == [(1, [1, "nccl"]), (2, [1, "nccl"])], res_c)
    hp_c = HParams.create(DP_HPARAMS)
    sample = train_batch(hp_c, 2, 32, 64)
    worst_c = compare_states(
        restored_state(hp_c, sample, os.path.join(root, "nccl_iter1.ckpt")),
        restored_state(hp_c, sample, glob_one(ref_out, ".ckpt")),
        what="data parallel, NCCL world size 1 vs no group",
        **DP_STATE_TOL)
    log(f"[data-parallel] (c) torchrun --nproc_per_node=1, NCCL: 1 then 2 "
        f"iterations in {nccl_s:.2f} s; the first G step against the run "
        "without a group, worst share of assert_states_match's tolerances: "
        + "; ".join(f"{k} {raw_share(worst_c, DP_STATE_TOL, k):.3f} "
                    f"({worst_c[k][1]})"
                    for k in ("first_moment", "second_moment", "param",
                              "stats"))
        + f"; phase {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return {"checks": checks, "parity_s": parity_s,
            "parity_worst": {k: worst[k] for k in worst},
            "parity_spread": spread,
            "parity_metric_rel_err": rel, "cli_s": cli_s,
            "cli": res, "s_per_iteration": dp_s_it,
            "phase14_s_per_iteration": loop_s_per_iteration,
            "schedule": seq, "checkpoints": ckpts,
            "mel_launches": mel_first, "qmm_launches": qmm_dp,
            "nccl_s": nccl_s, "nccl": res_c,
            "nccl_worst": {k: worst_c[k] for k in worst_c},
            "phase_s": time.perf_counter() - t_phase}


# Phase 25: the study campaigns through run_study, at the study model's own
# width (scripts/_study_common.small_model_params) with depth cut.
STUDY_QUEUE = ["mode/gan:0", "continuous/cont_warm:0"]
STUDY_ITERATIONS = 8
# 16 training utterances (one batch of the study's 16) + 10 validation.
STUDY_N_UTTS = 26
# The committed JAX file of each output, whose top-level fields the port's
# must have in the same order (the JAX package's TPU results).
STUDY_FIELDS = {
    "mode_study": "docs/evidence_r4/mode_study/infogan_bit_mode_study.json",
    "continuous_study": "docs/evidence_r5/continuous/cont_warm_s0.json",
    "mode_attribution": "docs/evidence_r4/mode_study/"
                        "infogan_bit_warm_rerun_mode_attribution_best.json",
    "calibrate_knob": "docs/evidence_r5/continuous/"
                      "calibrated_cont_warm_s0.json",
    "continuous_extrapolation": "docs/evidence_r5/continuous/"
                                "extrapolation_cont_warm_s0.json"}
# The post-hoc tools' cut grids.
ATTRIBUTION_GRID = ["--n_styles", "8", "--n_dropout", "4"]
KNOB_GRID = ["--n_codes", "11", "--code_draws", "4"]


def study_launches(text):
    """The ``{"kernel_launches": ...}`` lines of a study log, in order."""
    return [json.loads(line)["kernel_launches"]
            for line in text.splitlines()
            if line.startswith('{"kernel_launches"')]


def phase_studies(smi, kind, root):
    """25. The study campaigns on the card (gantron_tpu_torch/scripts/):
    ``run_study --queue mode/gan:0 continuous/cont_warm:0`` at the study
    model's width (the 96-dim model of ``small_model_params``: batch 16,
    64 decoder steps), its depth cut to 8 iterations (a validation and a
    checkpoint at each) on 26-utterance corpora (16 training, 10
    validation) with the studies' own scoring grids (80 free-running
    samples; an 11 x 8 code sweep and a 16 x 8 style grid); the mode arm
    rerun with ``--analyze_only``; then on those checkpoints
    ``mode_attribution`` in float32 and on an int8 generator
    (``--hparams quantized_inference=True``, ``--select best``), each on an
    8 x 4 grid, ``calibrate_knob`` and ``continuous_extrapolation`` on
    11-code sweeps of 4 draws (the post-hoc tools at once, each its own
    process), and the repository's ``summarize_continuous.py`` and
    ``summarize_round4.py`` over the outputs. The default output roots
    land in ``root`` (TMPDIR). Checks: every process exits 0; each JSON
    has the committed JAX file's top-level fields in order and names the
    card; mel launches one a cold wav (26 a study), then 0 (the rerun and
    the post-hoc tools); qmm 0 except the int8 attribution's 4 a decoder
    step (4 x 64 x 4)."""
    t_phase = time.perf_counter()
    env = dict(worker_env(), TMPDIR=root)
    checks = {}

    def check(name, ok, detail):
        checks[name] = bool(ok)
        if not ok:
            raise AssertionError(f"studies: {name}: {detail}")

    def fields(name, result):
        with open(os.path.join(REPO, STUDY_FIELDS[name])) as f:
            want = list(json.load(f).keys())
        check(f"{name} fields", list(result.keys()) == want,
              (list(result.keys()), want))
        check(f"{name} device", kind in result["device"], result["device"])

    runner = [sys.executable, "-m", "gantron_tpu_torch.scripts.run_study"]
    cut = ["--iterations", str(STUDY_ITERATIONS),
           "--n_utts", str(STUDY_N_UTTS), "--device", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(runner + ["--queue", *STUDY_QUEUE] + cut,
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    queue_s = time.perf_counter() - t0
    mode_root = os.path.join(root, "torch_modestudy")
    cont_root = os.path.join(root, "torch_contstudy")
    logs = {}
    for arm, r in (("mode", mode_root), ("continuous", cont_root)):
        path = os.path.join(r, "progress.log")
        logs[arm] = open(path).read() if os.path.exists(path) else ""
    check("run_study --queue exits 0", proc.returncode == 0,
          f"{proc.stdout}{proc.stderr[-2000:]}\n"
          + "\n".join(v[-3000:] for v in logs.values()))
    with open(os.path.join(mode_root, "gan", "mode_study.json")) as f:
        mode = json.load(f)
    with open(os.path.join(cont_root, "cont_warm",
                           "continuous_study.json")) as f:
        cont = json.load(f)
    fields("mode_study", mode)
    fields("continuous_study", cont)
    launches = {"mode_study": study_launches(logs["mode"])[-1],
                "continuous_study": study_launches(logs["continuous"])[-1]}
    for r in (mode, cont):
        check(f"{r['variant']} ran", r["iterations"] == STUDY_ITERATIONS
              and math.isfinite(r["final_validation"]["Validation mel loss"]),
              r["final_validation"])
    t0 = time.perf_counter()
    proc = subprocess.run(runner + ["--arm", "mode/gan", "--analyze_only"]
                          + cut, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    rerun_s = time.perf_counter() - t0
    with open(os.path.join(mode_root, "progress.log")) as f:
        log_text = f.read()
    check("--analyze_only exits 0", proc.returncode == 0, log_text[-3000:])
    launches["mode_study --analyze_only"] = study_launches(log_text)[-1]
    with open(os.path.join(mode_root, "gan", "mode_study.json")) as f:
        rerun = json.load(f)
    check("--analyze_only reread the checkpoint",
          rerun["analyze_only"] and rerun["iterations"] == STUDY_ITERATIONS
          and rerun["real_anchors"] == mode["real_anchors"], rerun)

    # The post-hoc tools on those checkpoints, at once.
    run_dir = os.path.join(mode_root, "gan")
    mode_args = ["--run_dir", run_dir, "--variant", "gan", "--iterations",
                 str(STUDY_ITERATIONS), *ATTRIBUTION_GRID, "--device",
                 "cuda"]
    tools = {
        "mode_attribution": ("mode_attribution", mode_args),
        "mode_attribution_int8": (
            "mode_attribution", mode_args + [
                "--hparams", "quantized_inference=True", "--select",
                "best"]),
        "calibrate_knob": ("calibrate_knob", [
            "--study_root", cont_root, *KNOB_GRID, "--n_targets", "3",
            "--check_draws", "4", "--device", "cuda"]),
        "continuous_extrapolation": ("continuous_extrapolation", [
            "--study_root", cont_root, *KNOB_GRID, "--device", "cuda"])}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"gantron_tpu_torch.scripts.{module}",
         *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, (module, args) in tools.items()}
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=600)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    tools_s = time.perf_counter() - t0
    for name, p in procs.items():
        check(f"{name} exits 0", p.returncode == 0, outs[name][-4000:])
        launches[name] = study_launches(outs[name])[-1]
    written = {}
    for name, path in (
            ("mode_attribution", os.path.join(run_dir,
                                              "mode_attribution.json")),
            ("mode_attribution_int8",
             os.path.join(run_dir, "mode_attribution_best.json")),
            ("calibrate_knob", os.path.join(
                cont_root, "calibrated_cont_warm_s0.json")),
            ("continuous_extrapolation", os.path.join(
                cont_root, "extrapolation_cont_warm_s0.json"))):
        with open(path) as f:
            written[name] = json.load(f)
        fields(name.replace("_int8", ""), written[name])
    n_dropout = int(ATTRIBUTION_GRID[-1])
    int8_qmm = 4 * 64 * n_dropout
    check("mel launches: one a cold wav, then 0",
          launches["mode_study"]["mel"] == STUDY_N_UTTS
          and launches["continuous_study"]["mel"] == STUDY_N_UTTS
          and all(v["mel"] == 0 for k, v in launches.items()
                  if k not in ("mode_study", "continuous_study")),
          launches)
    check("qmm launches: 4 a step on the int8 decode, else 0",
          launches["mode_attribution_int8"]["qmm"] == int8_qmm
          and all(v["qmm"] == 0 for k, v in launches.items()
                  if k != "mode_attribution_int8"), launches)

    # The repository's summarizers read the outputs (summarize_round4
    # wants <root>/modestudy/<arm>/).
    r4 = os.path.join(root, "round4")
    os.makedirs(r4)
    os.symlink(mode_root, os.path.join(r4, "modestudy"))
    summaries = {}
    for name, arg in (("summarize_continuous", cont_root),
                      ("summarize_round4", r4)):
        out = os.path.join(root, f"{name}.json")
        proc = subprocess.run([sys.executable, os.path.join(
            REPO, "scripts", f"{name}.py"), arg, "-o", out], cwd=REPO,
            capture_output=True, text=True, timeout=120)
        check(f"{name} exits 0", proc.returncode == 0, proc.stderr[-2000:])
        with open(out) as f:
            summaries[name] = json.load(f)
    check("summaries name the arms",
          [a["arm"] for a in summaries["summarize_continuous"]["arms"]]
          == ["cont_warm"]
          and [(a["arm"], a["grid"]) for a in
               summaries["summarize_round4"]["mode_arms"]]
          == [("gan", f"8x{n_dropout}")], summaries)

    s_it = {r["variant"]: r["train_seconds"] / STUDY_ITERATIONS
            for r in (mode, cont)}
    phase_s = time.perf_counter() - t_phase
    mode_val = mode["final_validation"]["Validation mel loss"]
    int8, knob = written["mode_attribution_int8"], written["calibrate_knob"]
    log(f"[studies] run_study --queue {' '.join(STUDY_QUEUE)} "
        f"({STUDY_ITERATIONS} iterations, {STUDY_N_UTTS} wavs, study width): "
        f"{queue_s:.1f} s; seconds an iteration (train_seconds / "
        f"{STUDY_ITERATIONS}, a validation and a checkpoint each) "
        + ", ".join(f"{k} {v:.3f}" for k, v in s_it.items())
        + f"; mode val mel {mode_val:.4f}, frac_hi "
        f"{mode['generated']['frac_hi']}; cont_warm sweep rho "
        f"{cont['control']['spearman']}, coverage "
        f"{cont['control']['range_coverage']}; --analyze_only {rerun_s:.1f} s;"
        f" post-hoc tools at once {tools_s:.1f} s (int8 attribution "
        f"consistency {int8['within_noise_consistency']}, knob mean error "
        f"{knob['mean_abs_err_frac_of_range']} of the range); launches "
        f"{json.dumps(launches)}; phase {phase_s:.1f} s [{smi}]")
    return {"checks": checks, "launches": launches, "queue_s": queue_s,
            "analyze_only_s": rerun_s, "post_hoc_s": tools_s,
            "s_per_iteration": s_it,
            "train_seconds": {r["variant"]: r["train_seconds"]
                              for r in (mode, cont)},
            "mode_study": {k: mode[k] for k in ("final_validation",
                                                "generated", "device")},
            "continuous_study": {k: cont[k] for k in ("final_validation",
                                                      "control", "device")},
            "qmm_launches": launches["mode_attribution_int8"]["qmm"],
            "mel_launches": {k: v["mel"] for k, v in launches.items()},
            "phase_s": phase_s}


def glob_one(d, suffix):
    names = [n for n in os.listdir(d) if n.endswith(suffix)]
    if len(names) != 1:
        raise AssertionError(f"{d}: {names} (one *{suffix} expected)")
    return os.path.join(d, names[0])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chip_smoke_out",
                        help="directory for the profiler traces")
    parser.add_argument("--worker", nargs=argparse.REMAINDER,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.worker:  # one process of phase 24
        return dp_worker(*args.worker)
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
    serving, launches, synth, waveglow, (mel_b8, wav_b8) = \
        phase_serving(hp, smi)
    trace = phase_trace(synth, hp, args.out)
    data = phase_data(hp)
    roundtrip = phase_roundtrip(hp, wav_b8)
    griffin_lim = phase_griffin_lim(synth, hp, smi)
    streaming = phase_streaming(synth, hp, smi)
    train_parity = phase_train_parity(smi)
    train_corpus = phase_train_corpus(smi)
    train_bench = phase_train_bench(smi, args.out)
    with tempfile.TemporaryDirectory() as root:
        train_loop, best = phase_train_loop(smi, root)
        sampling = phase_sampling(smi, best, root)
    conditioned = phase_conditioned(waveglow, smi)
    with tempfile.TemporaryDirectory() as root:
        exported = phase_export(synth, hp, smi, root)
    waveglow_forward = phase_waveglow_forward(mel_b8, wav_b8, smi)
    rtf_cli = phase_rtf_cli(smi, kind)
    bench_cli = phase_bench_cli(kind)
    with tempfile.TemporaryDirectory() as root:
        eval_toolkit = phase_eval_toolkit(smi, root)
    with tempfile.TemporaryDirectory() as root:
        identification, trained = phase_identification(smi, root,
                                                       train_bench)
        calibration = phase_calibration(smi, root, trained)
    with tempfile.TemporaryDirectory() as root:
        data_parallel = phase_data_parallel(
            smi, root, train_loop["first"]["s_per_iteration"])
    with tempfile.TemporaryDirectory() as root:
        studies = phase_studies(smi, kind, root)

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
        "griffin_lim": griffin_lim, "streaming": streaming,
        "launches_by_path": {"serving": launches,
                             "streaming": path_launches(streaming,
                                                        "qmm_launches"),
                             "training_corpus":
                                 train_corpus["qmm_launches"],
                             "training_loop": [
                                 train_loop["first"]["qmm_launches"],
                                 train_loop["resumed"]["qmm_launches"]],
                             "sampling": sampling["qmm_launches"],
                             "conditioned": conditioned["qmm_launches"],
                             "export": exported["qmm_launches"],
                             "rtf_cli": {k: r["qmm_launches"]
                                         for k, r in rtf_cli.items()},
                             "study": eval_toolkit["study"]["qmm_launches"],
                             "identification": {
                                 arm: identification[arm]["loop"][
                                     "qmm_launches"] for arm in "AB"},
                             "calibration": {
                                 "measure_knob":
                                     calibration["knob_qmm_launches"],
                                 "infer_mel_level": {
                                     k: v["qmm_launches"] for k, v in
                                     calibration["serve"].items()}},
                             "data_parallel": data_parallel[
                                 "qmm_launches"],
                             "studies": {
                                 k: v["qmm"] for k, v in
                                 studies["launches"].items()}},
        "training_loop": train_loop, "sampling": sampling,
        "conditioned": conditioned, "export": exported,
        "rtf_cli": rtf_cli,
        "waveglow_forward": waveglow_forward,
        "eval_toolkit": eval_toolkit,
        "identification": identification, "calibration": calibration,
        "data_parallel": data_parallel, "studies": studies, "gpu": smi,
    }
    t = mel["timings"]["B=8x220500"]
    mel_entry = {
        "name": "mel", "route": "cuda",
        "source": "gantron_tpu_torch/csrc/mel.cu",
        "replaces": "gantron_tpu/ops/pallas_mel.py:62",
        "launches": data["mel_launches"], "max_abs_err": mel["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "tol": {"atol": MEL_ATOL},
        "timed": "B=8 x 220500 samples (862 frames each), float32",
        "shapes": [[B, N] for B, N in MEL_SHAPES],
        "timings_by_shape": mel["timings"], "checks": mel["checks"],
        "data_path": data, "roundtrip": roundtrip,
        "launches_by_path": {"data": data["mel_launches"],
                             "roundtrip": roundtrip["launches"],
                             "streaming": path_launches(streaming,
                                                        "mel_launches"),
                             "training_corpus":
                                 train_corpus["mel_launches"],
                             "training_loop": [
                                 train_loop["first"]["mel_launches"],
                                 train_loop["resumed"]["mel_launches"]],
                             "check_kmeans": eval_toolkit["clis"][
                                 "check_kmeans"]["mel_launches"],
                             "clustering": eval_toolkit["clis"][
                                 "clustering"]["mel_launches"],
                             "identification": {
                                 arm: identification[arm]["loop"][
                                     "mel_launches"] for arm in "AB"},
                             "mode_study": calibration["mel_launches"],
                             "data_parallel": data_parallel[
                                 "mel_launches"],
                             "studies": studies["mel_launches"]},
        "training": {"parity": train_parity, "corpus": train_corpus,
                     "bench_shape": train_bench, "bench_cli": bench_cli},
        "gpu": smi,
    }
    print(json.dumps({"kernels": [qmm_entry, mel_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
