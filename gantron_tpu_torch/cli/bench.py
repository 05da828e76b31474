"""Training steps per second of the PyTorch port on one CUDA card
(counterpart of the root ``bench.py``).

    python -m gantron_tpu_torch.cli.bench [--frames_per_step K]

Runs the vanilla GANtron configuration (``use_labels=False,use_noise=True``,
BASELINE config 1) with ``fp16_run`` (bfloat16 forward copies of float32
master weights) at the reference's production shape, batch 32, T_in 128,
T_out 640, on ``bench.py``'s synthetic LJSpeech-like batch (the same
``RandomState(0)`` draws), timing the production G/G/D cycle with attention
weight 10: 4 warm-up cycles, then 5 trials of 12 cycles each.

Prints ONE JSON line with ``bench.py``'s fields: ``value`` is the median
steps/s of the trials, ``spread_pct`` their range over the median;
``flops_per_step`` is the floating-point operations of one G step and one D
step, backward passes and the gradient penalty's double backward included,
as ``torch.utils.flop_counter.FlopCounterMode`` counts them (matmuls and
convolutions; it stands in for XLA's cost analysis in ``bench.py``), over
the three steps of a cycle; ``mfu`` = median steps/s x flops_per_step /
the card's peak dense bfloat16 rate (``PEAK_BF16_FLOPS``, keyed by the CUDA
device name). ``device`` is the CUDA device's name and ``gpu`` the
``nvidia-smi`` name and power limit.

With no CUDA card it prints a skip record (``"skipped":
"gpu-unavailable"``, ``value`` null) and exits 0, as ``bench.py`` does for a
TPU outage: that is its one exit without a measurement.
"""

import argparse
import json

import numpy as np

V100_BASELINE_STEPS_PER_SEC = 1.8  # bench.py's 1x baseline
BATCH = 32
T_IN = 128
T_OUT = 640
WARMUP_CYCLES = 4
TIMED_CYCLES = 12  # each cycle = 2 G steps + 1 D step
TRIALS = 5
ATTN_WEIGHT = 10.0
# Peak dense bfloat16 FLOP/s by CUDA device name (NVIDIA's data sheet); a
# card not listed gets no MFU.
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}


def metric_name(frames_per_step: int) -> str:
    ktag = f", K={frames_per_step}" if frames_per_step != 1 else ""
    return ("LJSpeech-shape GAN train steps/sec/device "
            f"(batch {BATCH}, T_out {T_OUT}, G/G/D cycle{ktag})")


def make_batch(hp, seed=0, B=None, T_in=T_IN, T_out=T_OUT):
    """``bench.py``'s synthetic batch, draw for draw, as a numpy ``Batch``:
    random ids (no padding symbols), ragged text and mel lengths (the first
    sample full length), log-mel-like values zeroed past each length, gate
    targets 1 from each last frame on. ``T_in``/``T_out`` cut the shape for
    a short run on the CPU."""
    from gantron_tpu_torch.train.step import Batch

    B = B or BATCH
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
        mels[b, :, output_lengths[b]:] = 0
        gate[b, output_lengths[b] - 1:] = 1
    return Batch(text, text_lengths, mels, gate, np.zeros((B,), np.int32),
                 np.zeros((B, 5), np.float32), output_lengths)


def count_flops(g_step, d_step, state, batch, g_lr, d_lr):
    """(G-step FLOPs, D-step FLOPs) of one step each from ``state`` (which
    they update), forward and backward, as ``FlopCounterMode`` counts."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        state, _, (mel, lens) = g_step(state, batch, g_lr, ATTN_WEIGHT)
    g_flops = counter.get_total_flops()
    with FlopCounterMode(display=False) as counter:
        d_step(state, batch.mels, batch.output_lengths, mel, lens, d_lr)
    return g_flops, counter.get_total_flops()


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames_per_step", type=int, default=1,
                        help="decoder K (n_frames_per_step)")
    return parser.parse_args(argv)


def main(argv=None, trials=TRIALS, timed_cycles=TIMED_CYCLES,
         warmup_cycles=WARMUP_CYCLES):
    """Runs the benchmark and returns the record it printed. ``trials``,
    ``timed_cycles`` and ``warmup_cycles`` shorten it for a smoke run."""
    args = parse_args(argv)
    metric = metric_name(args.frames_per_step)

    import torch

    if not torch.cuda.is_available():
        record = {"metric": metric, "value": None, "unit": "steps/sec",
                  "vs_baseline": None, "skipped": "gpu-unavailable",
                  "error": "torch.cuda.is_available() is False"}
        print(json.dumps(record), flush=True)
        return record

    from gantron_tpu_torch.cli.rtf import gpu_line
    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.train.state import create_train_state
    from gantron_tpu_torch.train.step import make_train_steps, to_device
    from gantron_tpu_torch.utils.profiling import StepTimer

    hp = HParams.create("use_labels=False,use_noise=True,fp16_run=True,"
                        f"n_frames_per_step={args.frames_per_step}")
    batch = to_device(make_batch(hp), "cuda")
    state, G, D, g_tx, d_tx = create_train_state(hp, 0, batch, "cuda")
    g_step, d_step, _ = make_train_steps(hp, G, D, g_tx, d_tx)
    g_lr, d_lr = hp.g_learning_rate, hp.d_learning_rate

    def run_cycle(state):
        state, _, _ = g_step(state, batch, g_lr, ATTN_WEIGHT)
        state, gm, (mel, lens) = g_step(state, batch, g_lr, ATTN_WEIGHT)
        state, dm = d_step(state, batch.mels, batch.output_lengths, mel,
                           lens, d_lr)
        return state, gm, dm

    for _ in range(warmup_cycles):
        state, gm, dm = run_cycle(state)
    float(gm["generator_loss"]), float(dm["discriminator_loss"])
    torch.cuda.synchronize()

    card = torch.device("cuda")
    timer, trial_sps = StepTimer(sync=True), []
    for _ in range(trials):
        timer.start(card)
        for _ in range(timed_cycles):
            state, gm, dm = run_cycle(state)
        losses = float(gm["generator_loss"]), float(dm["discriminator_loss"])
        trial_sps.append(timed_cycles * 3 / timer.stop(card))
    if not np.isfinite(losses).all():
        raise RuntimeError(f"bench: a loss is not finite: {losses}")

    trial_sps.sort()
    median = trial_sps[len(trial_sps) // 2]
    g_flops, d_flops = count_flops(g_step, d_step, state, batch, g_lr, d_lr)
    flops_per_step = (2 * g_flops + d_flops) / 3
    device = torch.cuda.get_device_name(0)
    peak = PEAK_BF16_FLOPS.get(device)
    record = {
        "metric": metric, "value": median, "unit": "steps/sec",
        "vs_baseline": median / V100_BASELINE_STEPS_PER_SEC,
        "median": median, "min": trial_sps[0], "max": trial_sps[-1],
        "spread_pct": (trial_sps[-1] - trial_sps[0]) / median * 100,
        "trials": trials, "cycles_per_trial": timed_cycles,
        "warmup_cycles": warmup_cycles, "trial_steps_per_s": trial_sps,
        "flops_per_step": flops_per_step,
        "g_step_flops": g_flops, "d_step_flops": d_flops,
        "mfu": median * flops_per_step / peak if peak else None,
        "peak_bf16_flops": peak,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "device": device, "gpu": gpu_line(),
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
