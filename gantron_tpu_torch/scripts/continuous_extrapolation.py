"""Is the continuous knob's partial range coverage a GAIN limit or a
SATURATION limit? (port of scripts/continuous_extrapolation.py)

The continuous campaign measured seed-variable range coverage of the 1-dim
continuous code over the TRAINING code box [0.05, 0.95]. Two readings are
possible:

  * gain limit — the learned code->level map is roughly linear but too
    shallow; sweeping the code BEYOND the unit box keeps extending the
    level, so post-hoc code calibration reaches the full real range;
  * saturation limit — the map flattens at the box edge; only retraining
    (e.g. the calibrated diversity cap, ``continuous/cont_warm_cap045``)
    can recover it.

This sweeps a trained cont_warm checkpoint over an EXTENDED code range
(default [-0.45, 1.45], 21 points, ``eval.calibration.measure_knob``) and
reports in-box vs extended achieved range + a per-edge saturation
verdict. The campaign's JSON is the arm's ``continuous_study.json`` under
``--study_root`` unless ``--evidence DIR`` names a directory of campaign
JSONs (``<variant>_s<seed>.json``). Writes
``extrapolation_<variant>_s<seed>.json`` into ``--study_root`` unless
``-o`` says where.

Usage:
  python -m gantron_tpu_torch.scripts.continuous_extrapolation \
      --study_root DIR --seed 0 [--device cpu]
"""

import argparse
import json
import os

from gantron_tpu_torch.scripts._study_common import (add_device_argument,
                                                     default_root,
                                                     device_label,
                                                     print_launches,
                                                     study_sequence)

CODE_LO, CODE_HI = 0.05, 0.95  # the training box (gan_continuous_study)


def _r4(x):
    return None if x is None else round(x, 4)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--study_root", default=default_root("contstudy"))
    parser.add_argument("--variant", default="cont_warm")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--lo", type=float, default=-0.45)
    parser.add_argument("--hi", type=float, default=1.45)
    parser.add_argument("--n_codes", type=int, default=21)
    parser.add_argument("--code_draws", type=int, default=8)
    parser.add_argument("--evidence", default=None,
                        help="a directory of campaign JSONs (default: the "
                             "arm's continuous_study.json)")
    parser.add_argument("-o", "--output", default=None)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    args.evidence_name = None
    return args


def main(argv=None):
    args = parse_args(argv)

    import numpy as np

    from gantron_tpu_torch.data.toy import MODEBAND_SCORE
    from gantron_tpu_torch.eval.calibration import measure_knob
    from gantron_tpu_torch.eval.mode_study import band_channels, hiband_level
    from gantron_tpu_torch.scripts.calibrate_knob import (hparams_for,
                                                          read_campaign)
    from gantron_tpu_torch.train.checkpoint import CheckpointManager
    from gantron_tpu_torch.utils.loading import load_generator

    campaign, _, arm = read_campaign(args)
    real_p5 = campaign["real_curve"]["p5"]
    real_p95 = campaign["real_curve"]["p95"]
    real_range = real_p95 - real_p5
    hp = hparams_for(args, campaign)

    ckpt_path = CheckpointManager(arm).latest()
    model = load_generator(ckpt_path, hp, args.device)
    channels = band_channels(hp, *MODEBAND_SCORE)

    # The campaign's shared sweep protocol, via its one implementation.
    code_values, levels = measure_knob(
        model, hp, study_sequence(),
        score_fn=lambda mel: hiband_level(mel, channels),
        code_values=np.linspace(args.lo, args.hi, args.n_codes),
        n_draws=args.code_draws, seed=args.seed)
    cell_means = levels.mean(axis=1)

    in_box = (code_values >= CODE_LO - 1e-9) & (code_values <= CODE_HI + 1e-9)
    rng_in = float(cell_means[in_box].max() - cell_means[in_box].min())
    rng_ext = float(cell_means.max() - cell_means.min())

    # Per-edge saturation: slope (level units per code unit) just inside
    # the box vs in the extrapolated stretch beyond it. A slope ratio
    # near 0 = the map flattens at the edge (saturation); near 1 = the
    # knob keeps its gain outside the box (gain limit).
    def edge_slopes(side):
        step = code_values[1] - code_values[0]
        if side == "hi":
            inside = (code_values > CODE_HI - 3 * step) & in_box
            outside = code_values > CODE_HI + 1e-9
        else:
            inside = (code_values < CODE_LO + 3 * step) & in_box
            outside = code_values < CODE_LO - 1e-9

        def slope(mask):
            # A 1-point fit is underdetermined and an empty one raises;
            # report null (a sweep confined to the training box has no
            # outside points at all).
            if mask.sum() < 2:
                return None
            return float(np.polyfit(code_values[mask],
                                    cell_means[mask], 1)[0])

        return slope(inside), slope(outside)

    lo_in, lo_out = edge_slopes("lo")
    hi_in, hi_out = edge_slopes("hi")

    result = {
        "variant": args.variant,
        "seed": args.seed,
        "checkpoint": ckpt_path,
        "code_values": [round(float(c), 4) for c in code_values],
        "cell_means": [round(float(m), 4) for m in cell_means],
        "cell_stds": [round(float(s), 4) for s in levels.std(axis=1)],
        "real_range": round(real_range, 4),
        "range_in_box": round(rng_in, 4),
        "range_extended": round(rng_ext, 4),
        "coverage_in_box": round(rng_in / real_range, 4),
        "coverage_extended": round(rng_ext / real_range, 4),
        "edge_slope_lo": {"inside": _r4(lo_in), "outside": _r4(lo_out)},
        "edge_slope_hi": {"inside": _r4(hi_in), "outside": _r4(hi_out)},
        "campaign_coverage": campaign["control"]["range_coverage"],
        "device": device_label(args.device),
    }
    out_path = args.output or os.path.join(
        args.study_root, f"extrapolation_{args.variant}_s{args.seed}.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    print_launches()
    return result


if __name__ == "__main__":
    main()
