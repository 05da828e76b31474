"""Closed-loop validation of post-hoc knob calibration (port of
scripts/calibrate_knob.py).

For a trained continuous-knob checkpoint: measure the code->level curve
over an EXTENDED code range (``eval.calibration.measure_knob``), fit
``eval.calibration.KnobCalibration``, then CLOSE THE LOOP: request target
levels spanning the real factor range, synthesize at the calibrated codes
with FRESH nuisance draws, and score how close the decoded levels land.
Reports per-target error in units of the real range ("ask for -2 dB, get
-2 dB").

The campaign's JSON (its real-range percentiles, training iterations and
``--hparams``) is the arm's ``continuous_study.json`` under
``--study_root`` unless ``--evidence DIR`` names a directory of campaign
JSONs (``<variant>_s<seed>.json``, or ``--evidence_name``). Writes
``calibrated_<variant>_s<seed>.json`` (``calibrated_<evidence_name>``) into
``--study_root`` unless ``-o`` says where.

Usage:
  python -m gantron_tpu_torch.scripts.calibrate_knob --study_root DIR \
      --seed 0 [--device cpu]
"""

import argparse
import json
import os

from gantron_tpu_torch.scripts._study_common import (NOISE_STUDY,
                                                     add_device_argument,
                                                     arm_dir, default_root,
                                                     device_label,
                                                     print_launches,
                                                     study_hparams,
                                                     study_sequence)
from gantron_tpu_torch.scripts.gan_continuous_study import VARIANTS


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--study_root", default=default_root("contstudy"))
    parser.add_argument("--variant", default="cont_warm")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--lo", type=float, default=-0.45)
    parser.add_argument("--hi", type=float, default=1.45)
    parser.add_argument("--n_codes", type=int, default=21)
    parser.add_argument("--code_draws", type=int, default=8)
    parser.add_argument("--n_targets", type=int, default=5)
    parser.add_argument("--check_draws", type=int, default=8,
                        help="fresh nuisance draws per requested level")
    parser.add_argument("--evidence", default=None,
                        help="a directory of campaign JSONs (default: the "
                             "arm's continuous_study.json)")
    parser.add_argument("--evidence_name", default=None,
                        help="campaign JSON filename (default "
                             "<variant>_s<seed>.json); e.g. "
                             "cont_warm_cap045_s0.json for the "
                             "calibrated-cap arms, whose checkpoints use "
                             "the cont_warm architecture")
    parser.add_argument("-o", "--output", default=None)
    add_device_argument(parser)
    return parser.parse_args(argv)


def read_campaign(args):
    """(campaign JSON, its file name for the outputs, the arm's dir)."""
    arm = arm_dir(args.study_root, args.variant, args.seed)
    name = args.evidence_name or f"{args.variant}_s{args.seed}.json"
    path = (os.path.join(args.evidence, name) if args.evidence
            else os.path.join(arm, "continuous_study.json"))
    with open(path) as f:
        return json.load(f), name, arm


def hparams_for(args, campaign):
    """The arm's ``HParams``: the study's at the campaign's iterations,
    with the ``--hparams`` the campaign ran with (its
    ``hparams_override``)."""
    return study_hparams(campaign["iterations"],
                         dict(NOISE_STUDY, seed=5321 + args.seed),
                         VARIANTS[args.variant],
                         campaign.get("hparams_override"))


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from gantron_tpu_torch.data.toy import MODEBAND_SCORE
    from gantron_tpu_torch.eval.calibration import (KnobCalibration,
                                                    measure_knob)
    from gantron_tpu_torch.eval.mode_study import band_channels, hiband_level
    from gantron_tpu_torch.train.checkpoint import CheckpointManager
    from gantron_tpu_torch.utils.device import derive_seed, generator
    from gantron_tpu_torch.utils.loading import load_generator

    campaign, evidence_name, arm = read_campaign(args)
    real_p5 = campaign["real_curve"]["p5"]
    real_p95 = campaign["real_curve"]["p95"]
    hp = hparams_for(args, campaign)

    ckpt_path = CheckpointManager(arm).latest()
    model = load_generator(ckpt_path, hp, args.device)
    device = model.device
    seq = study_sequence()
    channels = band_channels(hp, *MODEBAND_SCORE)
    score = lambda mel: hiband_level(mel, channels)  # noqa: E731

    # --- fit on the extended sweep (its draws differ from the validation
    # draws below) --------------------------------------------------------
    codes, levels = measure_knob(
        model, hp, seq, score,
        code_values=np.linspace(args.lo, args.hi, args.n_codes),
        n_draws=args.code_draws, seed=args.seed)
    cal = KnobCalibration.fit(codes, levels)

    # --- closed loop: request levels spanning the real range -----------
    targets = np.linspace(real_p5, real_p95, args.n_targets)
    base = 9000 + args.seed
    text = torch.as_tensor(seq, device=device).expand(args.check_draws, -1)
    rows = []
    for t_i, target in enumerate(targets):
        style = torch.cat([
            cal.style_for_level(target, generator(
                device, derive_seed(base, t_i * 100 + d)), hp.noise_size)
            for d in range(args.check_draws)])
        out = model.infer(text, style, None, None, hp.max_decoder_steps,
                          generator=generator(device,
                                              derive_seed(base, 7000 + t_i)))
        mels, lens = out[1].cpu().numpy(), out[4].cpu().numpy()
        got = np.array([score(mels[i, :, : max(int(lens[i]), 2)])
                        for i in range(mels.shape[0])])
        rows.append({"target": round(float(target), 4),
                     "code": round(float(cal.code_for_level(target)), 4),
                     "achieved_mean": round(float(got.mean()), 4),
                     "achieved_std": round(float(got.std()), 4),
                     "abs_err": round(float(abs(got.mean() - target)), 4)})

    real_range = real_p95 - real_p5
    errs = np.array([r["abs_err"] for r in rows])
    result = {
        "variant": args.variant,
        "seed": args.seed,
        "checkpoint": ckpt_path,
        "real_range": round(real_range, 4),
        "calibration_coverage": round(cal.coverage(real_p5, real_p95), 4),
        "campaign_coverage_in_box": campaign["control"]["range_coverage"],
        "knob_sign": cal.sign,
        "targets": rows,
        "mean_abs_err": round(float(errs.mean()), 4),
        "mean_abs_err_frac_of_range": round(float(errs.mean()) / real_range,
                                            4),
        "max_abs_err_frac_of_range": round(float(errs.max()) / real_range, 4),
        "calibration": json.loads(cal.to_json()),
        "device": device_label(args.device),
    }
    # Named after the EVIDENCE name, not the variant: calibrating a cap045
    # checkpoint (--evidence_name cont_warm_cap045_s0.json) must not
    # overwrite the plain arm's calibrated_cont_warm_s0.json.
    out_path = args.output or os.path.join(args.study_root,
                                           f"calibrated_{evidence_name}")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("calibration", "checkpoint")}, indent=2))
    print_launches()
    return result


if __name__ == "__main__":
    main()
