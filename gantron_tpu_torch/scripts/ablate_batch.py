"""Batch scaling of the G step under the deferred-dW backward (bfloat16,
T_out 640; port of scripts/ablate_batch.py).

    python -m gantron_tpu_torch.scripts.ablate_batch [--device cpu]

At B = 32, 64 and 128 on bench.py's batch: 3 warm-up G steps, then the
median of 8; prints ms a step and samples a second, as the JAX script
does.
"""

from gantron_tpu_torch.scripts._study_common import device_label
from gantron_tpu_torch.scripts.ablate_deferred import (BASE, parse_args,
                                                       time_g_step)


def run(device="cuda", batches=(32, 64, 128), warmup=3, iters=8, **shape):
    """The sweep; ``shape`` (T_in, T_out) goes to ``time_g_step``. Returns
    {B: median s}."""
    print(f"device {device_label(device)}", flush=True)
    out = {}
    for B in batches:
        dt = time_g_step(BASE + ",deferred_dw=True", device, B=B,
                         warmup=warmup, iters=iters, **shape)[0]
        out[B] = dt
        print(f"B={B:<4d} g_step {dt*1e3:7.1f} ms  {B/dt:7.1f} samples/s",
              flush=True)
    return out


def main(argv=None):
    run(parse_args(argv).device)


if __name__ == "__main__":
    main()
