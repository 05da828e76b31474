"""``scan_unroll`` sweep on the full-size bfloat16 G step, batch 32, T_out
640 (port of scripts/ablate_unroll.py).

    python -m gantron_tpu_torch.scripts.ablate_unroll [--device cpu]

For unroll 8, 12 and 16: 4 warm-up G steps (their seconds printed as the
JAX script prints its compile and warm-up), then the median of 10. The
port accepts ``scan_unroll`` and ignores it (its decoder loop is eager),
so the three rows time the same step: their spread is the step's
run-to-run spread, as the script prints before them.
"""

from gantron_tpu_torch.scripts._study_common import device_label
from gantron_tpu_torch.scripts.ablate_deferred import (BASE, parse_args,
                                                       time_g_step)
from gantron_tpu_torch.scripts.ablate_deferred2 import UNROLL_IGNORED


def run(device="cuda", unrolls=(8, 12, 16), warmup=4, iters=10, **shape):
    """The sweep; ``shape`` goes to ``time_g_step``. Returns {unroll:
    (median s, warm-up s)}."""
    print(f"device {device_label(device)}", flush=True)
    print(UNROLL_IGNORED, flush=True)
    out = {}
    for unroll in unrolls:
        t, _, warm_s = time_g_step(BASE + f",scan_unroll={unroll}", device,
                                   warmup=warmup, iters=iters, **shape)
        out[unroll] = (t, warm_s)
        print(f"unroll={unroll:<3d} g_step {t*1e3:7.1f} ms  "
              f"(compile+warm {warm_s:.0f}s)", flush=True)
    return out


def main(argv=None):
    run(parse_args(argv).device)


if __name__ == "__main__":
    main()
