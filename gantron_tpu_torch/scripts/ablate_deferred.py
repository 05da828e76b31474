"""The G step with the deferred-dW backward on and off, at bench.py's shape
(port of scripts/ablate_deferred.py).

    python -m gantron_tpu_torch.scripts.ablate_deferred [--device cpu]

Both runs use ``use_labels=False,use_noise=True,fp16_run=True`` on
``cli/bench.py``'s synthetic batch (B 32, T_in 128, T_out 640) with
learning rate 1e-3 and attention weight 10, from the same seed: 3 warm-up
steps, then the median of 10 G steps, each timed on the host clock up to
a synchronize. Prints the JAX script's three lines (ms a step and the last
generator loss of each, the speedup) after the device's name.

``time_g_step`` takes the shape and the step counts, so that tests and
``chip_smoke.py`` can run it short; ``ablate_deferred2``, ``ablate_batch``
and ``ablate_unroll`` time their sweeps with it.
"""

import argparse
import statistics
import time

from gantron_tpu_torch.cli.bench import BATCH, T_IN, T_OUT, make_batch
from gantron_tpu_torch.scripts._study_common import (add_device_argument,
                                                     device_label)

BASE = "use_labels=False,use_noise=True,fp16_run=True"
LR, ATTN_WEIGHT = 1e-3, 10.0


def time_g_step(hp_string, device="cuda", B=BATCH, T_in=T_IN, T_out=T_OUT,
                warmup=3, iters=10, hp_over=None):
    """One G step of ``HParams.create(hp_string)`` (then ``hp_over``, a
    dict) on bench.py's batch of ``B`` x ``T_in`` / ``T_out``: the median
    seconds of ``iters`` synchronized steps after ``warmup``, the last
    generator loss, and the warm-up's seconds (the first step's cuDNN and
    allocator warm-up included)."""
    import torch

    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.train.state import create_train_state
    from gantron_tpu_torch.train.step import (Batch, make_train_steps,
                                              to_device)

    hp = HParams.create(hp_string)
    if hp_over:
        hp.add_params(hp_over)
    host = make_batch(hp, B=B, T_in=T_in, T_out=T_out)
    batch = to_device(Batch(*host), device)
    state, G, D, g_tx, d_tx = create_train_state(hp, 0, batch, device=device)
    g_step = make_train_steps(hp, G, D, g_tx, d_tx)[0]

    def step():
        nonlocal state
        t0 = time.perf_counter()
        state, metrics, _ = g_step(state, batch, LR, ATTN_WEIGHT)
        if batch.mels.is_cuda:
            torch.cuda.synchronize(batch.mels.device)
        return time.perf_counter() - t0, metrics

    t0 = time.perf_counter()
    for _ in range(warmup):
        step()
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        dt, metrics = step()
        times.append(dt)
    return (statistics.median(times), float(metrics["generator_loss"]),
            warm_s)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_argument(parser)
    return parser.parse_args(argv)


def run(device="cuda", **shape):
    """The script's measurement and lines; ``shape`` goes to
    ``time_g_step``. Returns {flag: (median s, loss)}."""
    print(f"device {device_label(device)}", flush=True)
    out = {}
    for flag in (True, False):
        t, loss, _ = time_g_step(f"{BASE},deferred_dw={flag}", device,
                                 **shape)
        out[flag] = (t, loss)
        pad = "  " if flag else " "
        print(f"g_step deferred_dw={flag}{pad} {t*1e3:7.1f} ms  "
              f"loss {loss:.4f}", flush=True)
    print(f"speedup {out[False][0] / out[True][0]:.3f}x", flush=True)
    return out


def main(argv=None):
    run(parse_args(argv).device)


if __name__ == "__main__":
    main()
