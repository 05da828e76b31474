"""Sweeps after the deferred-dW backward: ``scan_unroll`` and
``n_frames_per_step`` at bench.py's shape (port of
scripts/ablate_deferred2.py).

    python -m gantron_tpu_torch.scripts.ablate_deferred2 [--device cpu]

The G step (``ablate_deferred.time_g_step``, deferred-dW on) at
``scan_unroll`` 4, 8 and 16 with K = 1, then at K = 2 and 4, printing the
JAX script's lines. The port runs the decoder loop eagerly, one Python
iteration a step, and accepts ``scan_unroll`` without using it: the three
unroll readings time one and the same step, so their spread is the step's
run-to-run spread, which the script says before them.
"""

from gantron_tpu_torch.scripts._study_common import device_label
from gantron_tpu_torch.scripts.ablate_deferred import (BASE, parse_args,
                                                       time_g_step)

UNROLL_IGNORED = ("scan_unroll is accepted and ignored by the PyTorch port "
                  "(an eager loop has no scan to unroll): the unroll rows "
                  "time the same step, their spread is run-to-run noise")


def run(device="cuda", unrolls=(4, 8, 16), frames=(2, 4), **shape):
    """The sweep; ``shape`` goes to ``time_g_step``. Returns {label: median
    s}."""
    print(f"device {device_label(device)}", flush=True)
    print(UNROLL_IGNORED, flush=True)
    base = BASE + ",deferred_dw=True"
    out = {}
    for unroll in unrolls:
        t = time_g_step(base + f",scan_unroll={unroll}", device, **shape)[0]
        out[f"unroll={unroll} K=1"] = t
        print(f"unroll={unroll:<3d} K=1  g_step {t*1e3:7.1f} ms", flush=True)
    for k in frames:
        t = time_g_step(base + f",n_frames_per_step={k}", device, **shape)[0]
        out[f"unroll=8 K={k}"] = t
        print(f"unroll=8   K={k}  g_step {t*1e3:7.1f} ms", flush=True)
    return out


def main(argv=None):
    run(parse_args(argv).device)


if __name__ == "__main__":
    main()
