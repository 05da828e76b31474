"""Calibrate ``diversity_rescue_floor`` / ``diversity_rescue_ceiling`` from
measured checkpoints (port of scripts/calibrate_rescue_floor.py).

The collapse-rescue controller (train/loop.py, config.py
diversity_rescue_*) trips when the in-loop latent-separation probe leaves
its calibrated band. This replays the EXACT probe statistic the loop
computes (``eval.sampling.latent_separation`` — between-code / within-code
distance ratio on a (levels x draws) decode grid of the first validation
text) on the final checkpoints of the composed-capstone study arms, which
include measured-healthy seeds and measured-collapsed seeds (consistency
floor 1.0, every sample in one mode), and prints the two bands. The bound
belongs between them.

The measured direction (docs/TRAINING_EVIDENCE.md "Closed-loop rescue"):
every collapse under identification pressure scored ABOVE the healthy
band, because the Q loss keeps the code decodable and its effect migrates
off-manifold with outsized L1; a ratio ~ 1 occurs only without
identification terms. So the controller bounds the ratio from both sides
and this recommends whichever bound the measured bands support, over
IDENTIFICATION arms only (style_reconstruction_weight > 0).

Writes ``<-o>/rescue_floor_calibration.json``.

Usage:
  python -m gantron_tpu_torch.scripts.calibrate_rescue_floor \
      [-o COMPOSED_ROOT] [--mode_study_dir MODE_ROOT] [--device cpu]
"""

import argparse
import json
import os

from gantron_tpu_torch.scripts._study_common import (NOISE_STUDY,
                                                     add_device_argument,
                                                     corpus_dir, default_root,
                                                     print_launches,
                                                     study_hparams)


def probe_statistics(arm_dir, hp, wavs_path, device):
    """The loop's rescue-probe statistics at the arm's final checkpoint:
    the text is row 0 of the first validation batch (cut to its true
    length), decoded as the latent-separation grid from the probe's seed
    at iteration 0. Returns (separation_ratio, spread), or (None, None)
    without a checkpoint."""
    from gantron_tpu_torch.eval.sampling import latent_separation
    from gantron_tpu_torch.train.checkpoint import CheckpointManager
    from gantron_tpu_torch.utils.device import derive_seed, generator
    from gantron_tpu_torch.utils.loading import load_generator

    ckpt_path = CheckpointManager(arm_dir).latest()
    if ckpt_path is None:
        return None, None
    model = load_generator(ckpt_path, hp, device)
    text = probe_text(hp, wavs_path, device)
    # The loop seeds the probe by iteration; the statistic is an average
    # over many pairs, so the final checkpoint is read at the base seed.
    return latent_separation(model, hp, text, generator(
        model.device, derive_seed(hp.seed + 17, 0)))


def probe_text(hp, wavs_path, device):
    """(1, T) ids: row 0 of the first validation batch, cut to its true
    length (the loop's probe text)."""
    import numpy as np

    from gantron_tpu_torch.train.loop import prepare_dataloaders

    _, val_loader = prepare_dataloaders(hp, wavs_path, device)
    batch = next(iter(val_loader))
    t_len = max(int(batch.text_lengths[0]), 1)
    return np.asarray(batch.text)[:1, :t_len]


def arm_hparams(meta, variants, corpus_root, seed_base):
    """An arm's study ``HParams`` from its study JSON (iterations, seed,
    variant, --hparams) and its corpus's filelists."""
    return study_hparams(meta["iterations"], dict(
        NOISE_STUDY, seed=seed_base + meta["seed"],
        training_files=[os.path.join(corpus_root, "train.txt")],
        validation_files=[os.path.join(corpus_root, "val.txt")]),
        variants[meta["variant"]], meta.get("hparams_override"))


def _arm_row(arm_dir, name, variants, meta, ident, seed_base, device):
    """Score one study arm with the exact in-loop probe statistics."""
    variant, arm_seed = meta["variant"], meta["seed"]
    corpus_root = corpus_dir(os.path.dirname(arm_dir), arm_seed)
    hp = arm_hparams(meta, variants, corpus_root, seed_base)
    ratio, spread = probe_statistics(
        arm_dir, hp, os.path.join(corpus_root, "wavs") + os.sep, device)
    identifying = float(variants[variant].get(
        "style_reconstruction_weight", 0.0)) > 0
    collapsed = ident["consistency_chance_floor"] >= 0.999
    row = dict(arm=name, variant=variant, seed=arm_seed,
               separation=ratio, spread=spread,
               collapsed=bool(collapsed),
               identification_arm=identifying,
               chi2=ident["per_style_chi2"])
    print(f"{name:<22s} separation={ratio:.4f} spread={spread:.4f} "
          f"{'COLLAPSED' if collapsed else 'healthy':<9s} "
          f"chi2={ident['per_style_chi2']:.1f}"
          f"{'' if identifying else '  (non-identification arm)'}",
          flush=True)
    return row


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-o", "--output",
                        default=default_root("composedstudy"))
    parser.add_argument(
        "--mode_study_dir", default=None,
        help="optionally include bimodal-campaign arms "
        "(gan_mode_study layout) — their collapsed seeds are extra "
        "calibration points")
    add_device_argument(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np

    from gantron_tpu_torch.scripts.gan_composed_study import VARIANTS

    rows = []
    for name in sorted(os.listdir(args.output)):
        arm_dir = os.path.join(args.output, name)
        meta_path = os.path.join(arm_dir, "composed_study.json")
        if not os.path.isfile(meta_path):
            continue
        with open(meta_path) as f:
            meta = json.load(f)
        rows.append(_arm_row(arm_dir, name, VARIANTS, meta,
                             meta["identification"], seed_base=4321,
                             device=args.device))

    if args.mode_study_dir:
        from gantron_tpu_torch.scripts.gan_mode_study import \
            VARIANTS as MODE_VARIANTS

        for name in sorted(os.listdir(args.mode_study_dir)):
            arm_dir = os.path.join(args.mode_study_dir, name)
            meta_path = os.path.join(arm_dir, "mode_study.json")
            attr_path = os.path.join(arm_dir, "mode_attribution_best.json")
            if not (os.path.isfile(meta_path) and os.path.isfile(attr_path)):
                continue
            with open(meta_path) as f:
                meta = json.load(f)
            with open(attr_path) as f:
                attr = json.load(f)
            rows.append(_arm_row(arm_dir, f"bimodal:{name}", MODE_VARIANTS,
                                 meta, attr, seed_base=1234,
                                 device=args.device))

    ident_rows = [r for r in rows if r["identification_arm"]]
    healthy = [r["separation"] for r in ident_rows if not r["collapsed"]]
    collapsed = [r["separation"] for r in ident_rows if r["collapsed"]]
    other = [r["separation"] for r in rows if not r["identification_arm"]]
    summary = dict(rows=rows,
                   statistic="code_separation_ratio",
                   healthy_band=[min(healthy), max(healthy)]
                   if healthy else None,
                   collapsed_band=[min(collapsed), max(collapsed)]
                   if collapsed else None,
                   non_identification_separations=other)
    if healthy and collapsed and min(collapsed) > max(healthy):
        # The measured direction: collapse INFLATES the ratio -> bound it
        # with a CEILING.
        summary["recommended_ceiling"] = round(
            float(np.sqrt(min(collapsed) * max(healthy))), 4)
        print(f"\nidentification arms: healthy band <= {max(healthy):.4f}, "
              f"collapsed band >= {min(collapsed):.4f}, recommended "
              f"diversity_rescue_ceiling (geometric mid) = "
              f"{summary['recommended_ceiling']}")
    elif healthy and collapsed and min(healthy) > max(collapsed):
        summary["recommended_floor"] = round(
            float(np.sqrt(min(healthy) * max(collapsed))), 4)
        print(f"\nidentification arms: healthy band >= {min(healthy):.4f}, "
              f"collapsed band <= {max(collapsed):.4f}, recommended "
              f"diversity_rescue_floor (geometric mid) = "
              f"{summary['recommended_floor']}")
    elif healthy and collapsed:
        print(f"\nWARNING: bands overlap (healthy {min(healthy):.4f}-"
              f"{max(healthy):.4f} vs collapsed {min(collapsed):.4f}-"
              f"{max(collapsed):.4f}); no bound recommended")
    out_path = os.path.join(args.output, "rescue_floor_calibration.json")
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"wrote {out_path}")
    print_launches()
    return summary


if __name__ == "__main__":
    main()
