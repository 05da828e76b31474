"""Measure whether a FACTOR-AWARE separation probe can see factor collapse
(port of scripts/calibrate_factor_sensor.py).

The factorial campaign (docs/TRAINING_EVIDENCE.md "Factorial scaling
study") found the diagonal collapse sensor blind to factor collapse: every
factorial collapse kept the diagonal code-separation ratio inside the
single-bit-calibrated healthy band, because the code retains a visible
output effect while a FACTOR collapses. The per-dim probe
(``eval.sampling.latent_separation(dim=)``) sweeps ONE code dim with the
other dims and the nuisance shared per draw, so the between-level contrast
isolates that dim's output control.

This replays the diagonal AND per-dim statistics on the factorial
campaign's final checkpoints (per-band ground truth from each arm's
factorial_study.json) and reports whether any of them separates "band
identified" from "band collapsed" arms. Writes
``<-o>/factor_sensor_calibration.json``.

Usage:
  python -m gantron_tpu_torch.scripts.calibrate_factor_sensor \
      [-o FACTORIAL_ROOT] [--device cpu]
"""

import argparse
import json
import os

from gantron_tpu_torch.scripts._study_common import (add_device_argument,
                                                     corpus_dir, default_root,
                                                     print_launches)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-o", "--output",
                        default=default_root("factorial_r4"))
    add_device_argument(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np

    from gantron_tpu_torch.eval.sampling import latent_separation
    from gantron_tpu_torch.scripts.calibrate_rescue_floor import (
        arm_hparams, probe_text)
    from gantron_tpu_torch.scripts.gan_factorial_study import VARIANTS
    from gantron_tpu_torch.train.checkpoint import CheckpointManager
    from gantron_tpu_torch.utils.device import derive_seed, generator
    from gantron_tpu_torch.utils.loading import load_generator

    rows = []
    for name in sorted(os.listdir(args.output)):
        arm_dir = os.path.join(args.output, name)
        meta_path = os.path.join(arm_dir, "factorial_study.json")
        if not os.path.isfile(meta_path):
            continue
        with open(meta_path) as f:
            meta = json.load(f)
        variant, arm_seed = meta["variant"], meta["seed"]
        code_dims = int(VARIANTS[variant].get("style_code_dims", 0) or 0)
        if code_dims < 2:
            continue  # the factor-aware probe is only distinct there
        corpus_root = corpus_dir(args.output, arm_seed)
        hp = arm_hparams(meta, VARIANTS, corpus_root, seed_base=5321)
        ckpt_path = CheckpointManager(arm_dir).latest()
        if ckpt_path is None:
            continue
        model = load_generator(ckpt_path, hp, args.device)
        text = probe_text(hp, os.path.join(corpus_root, "wavs") + os.sep,
                          args.device)
        # The loop's probe seed at iteration 0; each grid decode starts
        # its generator there, so the per-dim grids share the diagonal
        # grid's nuisance draws.
        seed = derive_seed(hp.seed + 17, 0)
        diag, spread = latent_separation(model, hp, text,
                                         generator(model.device, seed))
        per_dim = [latent_separation(model, hp, text,
                                     generator(model.device, seed),
                                     dim=d)[0] for d in range(code_dims)]
        band_p = (meta["attribution_a"]["per_style_chi2_p"],
                  meta["attribution_b"]["per_style_chi2_p"])
        bands_identified = sum(1 for p in band_p if p < 0.01)
        row = dict(arm=name, variant=variant, seed=arm_seed,
                   iterations=meta["iterations"],
                   diagonal=round(float(diag), 4),
                   per_dim=[round(float(r), 4) for r in per_dim],
                   min_dim=round(float(min(per_dim)), 4),
                   spread=round(float(spread), 4),
                   band_p=band_p, bands_identified=bands_identified,
                   coverage=(meta.get("coverage") or {}).get("coverage"))
        rows.append(row)
        print(f"{name:<22s} diag={row['diagonal']:<7.3f} "
              f"per_dim={row['per_dim']} min={row['min_dim']:<7.3f} "
              f"bands_identified={bands_identified} "
              f"coverage={row['coverage']}", flush=True)

    both = [r["min_dim"] for r in rows if r["bands_identified"] == 2]
    partial = [r["min_dim"] for r in rows if r["bands_identified"] == 1]
    none = [r["min_dim"] for r in rows if r["bands_identified"] == 0]
    summary = dict(rows=rows, statistic="min over code dims of the per-dim "
                   "code_separation_ratio",
                   min_dim_both_bands=sorted(both),
                   min_dim_one_band=sorted(partial),
                   min_dim_no_band=sorted(none))
    if both and (partial or none):
        worst_healthy = min(both)
        best_sick = max(partial + none)
        sep = worst_healthy > best_sick
        summary["separates"] = bool(sep)
        if sep:
            summary["recommended_factor_floor"] = round(
                float(np.sqrt(worst_healthy * best_sick)), 4)
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"},
                     indent=2))
    out_path = os.path.join(args.output, "factor_sensor_calibration.json")
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"wrote {out_path}")
    print_launches()
    return summary


if __name__ == "__main__":
    main()
