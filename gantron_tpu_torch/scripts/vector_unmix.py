"""Closed-loop validation of VectorCalibration on vector-study checkpoints
(port of scripts/vector_unmix.py).

The vector study measured that a 2-dim continuous code identifies the
bileveled corpus's two factors only up to ROTATION. This tests the
designed consequence end to end on each trained checkpoint:

  1. FIT — sweep each code dim (``eval.calibration.measure_knob``), score
     BOTH bands per decode, fit the linear control matrix
     ``levels ~ c + M (code - 0.5)`` (``eval.calibration.
     VectorCalibration``).
  2. REQUEST — build 9 joint targets (``--targets grid``: independent
     per-band 20/50/80% of the sweep-achieved range, the joint-
     reachability test; ``--targets box``: the forward model of 9 in-box
     codes, the map-correctness test) and solve
     ``code = 0.5 + M^-1 (target - c)`` per target.
  3. VERIFY — decode the solved codes against fresh shared nuisance draws
     and measure what each band did: each band's achieved level should
     track ITS requested level (pooled Spearman) and not the OTHER band's,
     with hit error small against the real factor range.

Prints one result per seed; writes them all to ``-o`` when given.

Usage:
  python -m gantron_tpu_torch.scripts.vector_unmix --root DIR \
      --seeds 0 1 2 [--device cpu]
"""

import argparse
import json
import os

from gantron_tpu_torch.scripts._study_common import (NOISE_STUDY,
                                                     add_device_argument,
                                                     arm_dir, corpus_dir,
                                                     default_root,
                                                     print_launches,
                                                     study_hparams,
                                                     study_sequence)
from gantron_tpu_torch.scripts.gan_vector_study import VARIANTS

TARGET_FRACS = (0.2, 0.5, 0.8)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=default_root("vectorstudy"))
    parser.add_argument("--variant", default="vec_warm")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--n_draws", type=int, default=8)
    parser.add_argument("--targets", choices=("grid", "box"), default="grid",
                        help="'grid': independent per-band 3x3 targets "
                             "(joint reachability test — targets may fall "
                             "outside the code box's image and clip); "
                             "'box': targets are the forward model of 9 "
                             "in-box codes (map-correctness test — every "
                             "target reachable by construction)")
    parser.add_argument("--n_utts", type=int, default=200,
                        help="the study's corpus size (its real levels "
                             "are read from that corpus)")
    parser.add_argument("--hparams", type=str, default=None,
                        help="must repeat any --hparams the training runs "
                             "used")
    parser.add_argument("-o", "--output", default=None)
    add_device_argument(parser)
    return parser.parse_args(argv)


def hparams_for(args, seed, train_list):
    return study_hparams(6000, dict(
        NOISE_STUDY, seed=6321 + seed,
        training_files=[train_list], validation_files=[train_list]),
        VARIANTS[args.variant], args.hparams)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch
    from scipy import stats as sstats

    from gantron_tpu_torch.data.toy import (MODEBAND_SCORE, TEXBAND_SCORE,
                                            build_bileveled_corpus)
    from gantron_tpu_torch.eval.calibration import (VectorCalibration,
                                                    measure_knob)
    from gantron_tpu_torch.eval.mode_study import (band_channels,
                                                   compute_real_levels)
    from gantron_tpu_torch.scripts.gan_vector_study import band_scorer
    from gantron_tpu_torch.train.checkpoint import CheckpointManager
    from gantron_tpu_torch.utils.device import derive_seed, generator
    from gantron_tpu_torch.utils.loading import load_generator

    results = []
    for seed in args.seeds:
        wav_dir, train_list, _, levels_by_name = build_bileveled_corpus(
            corpus_dir(args.root, seed), n_utts=args.n_utts, seed=seed)
        hp = hparams_for(args, seed, train_list)

        ckpt_path = CheckpointManager(
            arm_dir(args.root, args.variant, seed)).latest()
        model = load_generator(ckpt_path, hp, args.device)
        device = model.device
        seq = study_sequence()
        channels = [band_channels(hp, *MODEBAND_SCORE),
                    band_channels(hp, TEXBAND_SCORE)]
        real = [compute_real_levels(
            train_list, wav_dir,
            {n: uv[b] for n, uv in levels_by_name.items()}, hp,
            channels=channels[b], device=args.device) for b in range(2)]
        real_range = [max(real[b]["p95"] - real[b]["p5"], 1e-9)
                      for b in range(2)]
        both_bands = band_scorer(channels)

        # 1. FIT ---------------------------------------------------------
        sweeps = [measure_knob(model, hp, seq, both_bands,
                               n_draws=args.n_draws, seed=seed, code_dim=d)
                  for d in range(2)]
        cal = VectorCalibration.fit(sweeps)

        # 2. REQUEST -----------------------------------------------------
        achieved_band = []  # per band: sweep-achieved cell-mean range
        for b in range(2):
            cells = np.concatenate([
                lv.mean(axis=1)[:, b] for _, lv in sweeps])
            achieved_band.append((float(cells.min()), float(cells.max())))
        if args.targets == "box":
            # Map-correctness protocol: request what the fitted model says
            # 9 spread-out IN-BOX codes produce — reachable by
            # construction, so failures indict the calibration map.
            g = np.linspace(0.15, 0.85, 3)
            box_codes = np.array([[a, b] for a in g for b in g])
            targets = np.array([cal.levels_for_code(cd)
                                for cd in box_codes])
        else:
            t_a = [achieved_band[0][0]
                   + f * (achieved_band[0][1] - achieved_band[0][0])
                   for f in TARGET_FRACS]
            t_b = [achieved_band[1][0]
                   + f * (achieved_band[1][1] - achieved_band[1][0])
                   for f in TARGET_FRACS]
            targets = np.array([[a, b] for a in t_a for b in t_b])
        codes, in_box = zip(*[cal.code_for_levels(t) for t in targets])
        codes = np.stack(codes)

        # 3. VERIFY ------------------------------------------------------
        S, T = args.n_draws, targets.shape[0]
        nuis = torch.rand((S, 1, hp.noise_size), device=device,
                          generator=generator(device,
                                              derive_seed(1234 + seed)))
        style = nuis.repeat(T, 1, 1)  # target-major
        style[:, 0, :2] = torch.as_tensor(
            codes, dtype=torch.float32, device=device).repeat_interleave(
                S, dim=0)
        text = torch.as_tensor(seq, device=device).expand(T * S, -1)
        o = model.infer(text, style, None, None, hp.max_decoder_steps,
                        generator=generator(device,
                                            derive_seed(1234 + seed, 1)))
        mels, lens = o[1].cpu().numpy(), o[4].cpu().numpy()
        ach = np.array([both_bands(mels[i, :, : max(int(lens[i]), 2)])
                        for i in range(T * S)]).reshape(T, S, 2)

        req = np.repeat(targets, S, axis=0).reshape(T, S, 2)
        stats = {}
        for b, bname in enumerate(("band_a", "band_b")):
            own = sstats.spearmanr(req[:, :, b].ravel(),
                                   ach[:, :, b].ravel())
            cross = sstats.spearmanr(req[:, :, 1 - b].ravel(),
                                     ach[:, :, b].ravel())
            # In box mode the 9 joint targets are themselves correlated
            # across bands, so the raw cross-Spearman conflates that with
            # leakage; the PARTIAL cross — achieved_b residualized on its
            # own request, then ranked against the other request — is the
            # independence statistic that is valid in both modes.
            own_x, ach_b = req[:, :, b].ravel(), ach[:, :, b].ravel()
            slope, icpt = np.polyfit(own_x, ach_b, 1)
            partial = sstats.spearmanr(req[:, :, 1 - b].ravel(),
                                       ach_b - (slope * own_x + icpt))
            err = ach[:, :, b].mean(axis=1) - targets[:, b]
            stats[bname] = {
                "own_spearman": round(float(own.statistic), 4),
                "own_p": float(own.pvalue),
                "cross_spearman": round(float(cross.statistic), 4),
                "partial_cross_spearman": round(
                    float(partial.statistic), 4),
                "partial_cross_p": float(partial.pvalue),
                "rms_err_vs_real_range": round(
                    float(np.sqrt((err ** 2).mean())) / real_range[b], 4),
            }
        results.append({
            "seed": seed,
            "ckpt": os.path.basename(ckpt_path),
            "matrix": cal.matrix.tolist(),
            "intercept": cal.intercept.tolist(),
            "condition_number": round(cal.condition_number, 2),
            "in_box": int(sum(in_box)),
            "n_targets": T,
            "target_mode": args.targets,
            "achieved_band_ranges": achieved_band,
            "real_ranges": real_range,
            "validation": stats,
            "calibration_json": cal.to_json(),
        })
        print(json.dumps(results[-1], indent=2))

    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    print_launches()
    return results


if __name__ == "__main__":
    main()
