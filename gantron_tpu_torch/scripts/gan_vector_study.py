"""Vector latent control (port of scripts/gan_vector_study.py): do TWO
continuous code dims become TWO knobs?

``data.toy.build_bileveled_corpus`` hides two independent continuous
factors (marker level u_a on [4.0, 4.8] kHz, u_b on >= 5.4 kHz, both
~ U(0, 1) over an 18 dB log-sweep, hidden from text/labels). Each arm is
scored by:

  * CONTROL MATRIX — sweep EACH code dim over [0.05, 0.95] (11 values x
    8 shared nuisance draws, ``eval.calibration.measure_knob``; the other
    code dim rides in the nuisance) and score BOTH bands on every decode:
    a 2x2 matrix of ``continuous_control_stats``, and its disentanglement
    summary (injective argmax assignment, own-band significance, margins);
  * ATTRIBUTION MATRIX — the shared random-style grid
    (``eval.sampling.attribution_level_grid``, both bands scored on the
    SAME decodes): Spearman between each drawn code dim and each band;
  * FIDELITY — final validation losses.

Arms: ``nogan`` (MSE floor) and ``vec_warm`` (the continuous campaign's
endpoint config with style_code_dims=2 and subset redraw); the calibrated
cap is ``run_study --arm vector/vec_warm_cap068``. Writes
``<out>/<variant>[_s<seed>]/vector_study.json``.

Usage:
  python -m gantron_tpu_torch.scripts.gan_vector_study --variant vec_warm \
      --seed 0 [-o DIR] [--device cpu]
"""

import argparse
import json
import os

from gantron_tpu_torch.scripts._study_common import (NOISE_STUDY,
                                                     add_device_argument,
                                                     arm_dir, corpus_dir,
                                                     default_root,
                                                     device_label,
                                                     print_launches,
                                                     study_hparams,
                                                     study_sequence, train_arm)

VARIANTS = {
    "nogan": {"d_freq": 0, "disc_warmp_up": 0},
    "vec_warm": {
        "adversarial_rollouts": True,
        "style_reconstruction_weight": 10.0,
        "diversity_weight": 1.0,
        "diversity_cap": 0.9,
        "identification_warmup": 1000,
        "validation_sample_diversity": 8,
        "style_code_dims": 2,
        "style_code_levels": 0,
        "diversity_subset_redraw": True,
    },
}

N_CODES = 11
CODE_LO, CODE_HI = 0.05, 0.95
BAND_NAMES = ("band_a", "band_b")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", choices=sorted(VARIANTS),
                        default="vec_warm")
    parser.add_argument("-o", "--output",
                        default=default_root("vectorstudy"))
    parser.add_argument("--iterations", type=int, default=3000)
    parser.add_argument("--n_utts", type=int, default=200)
    parser.add_argument("--n_styles", type=int, default=16)
    parser.add_argument("--n_dropout", type=int, default=8)
    parser.add_argument("--code_draws", type=int, default=8,
                        help="nuisance draws per swept code value")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--hparams", type=str, default=None)
    parser.add_argument("--analyze_only", action="store_true")
    add_device_argument(parser)
    return parser.parse_args(argv)


def hparams_for(args, train_list, val_list):
    return study_hparams(args.iterations, dict(
        NOISE_STUDY, seed=6321 + args.seed,
        training_files=[train_list], validation_files=[val_list]),
        VARIANTS[args.variant], args.hparams)


def band_scorer(channels):
    """mel -> (level on band a, level on band b)."""
    import numpy as np

    from gantron_tpu_torch.eval.mode_study import hiband_level

    return lambda mel: np.array([hiband_level(mel, ch) for ch in channels])


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    from scipy import stats as sstats

    from gantron_tpu_torch.data.toy import (MODEBAND_SCORE, TEXBAND_SCORE,
                                            build_bileveled_corpus)
    from gantron_tpu_torch.eval.calibration import measure_knob
    from gantron_tpu_torch.eval.mode_study import (band_channels,
                                                   compute_real_levels,
                                                   continuous_control_stats)
    from gantron_tpu_torch.eval.sampling import (attribution_level_grid,
                                                 attribution_styles)
    from gantron_tpu_torch.utils.loading import load_generator

    corpus_root = corpus_dir(args.output, args.seed)
    os.makedirs(corpus_root, exist_ok=True)
    wav_dir, train_list, val_list, levels_by_name = build_bileveled_corpus(
        corpus_root, n_utts=args.n_utts, seed=args.seed)
    hp = hparams_for(args, train_list, val_list)

    out = arm_dir(args.output, args.variant, args.seed)
    iteration, train_seconds, final_val, ckpt_path = train_arm(
        out, args.variant, hp, wav_dir, args.analyze_only, args.device)

    channels = [band_channels(hp, *MODEBAND_SCORE),
                band_channels(hp, TEXBAND_SCORE)]
    real = [compute_real_levels(
        train_list, wav_dir, {n: uv[b] for n, uv in levels_by_name.items()},
        hp, channels=channels[b], device=args.device) for b in range(2)]

    model = load_generator(ckpt_path, hp, args.device)
    seq = study_sequence()

    # --- CONTROL MATRIX: sweep each code dim, score both bands ----------
    code_values = np.linspace(CODE_LO, CODE_HI, N_CODES)
    control = {}
    rho = np.zeros((2, 2))
    for dim in range(2):
        _, levels = measure_knob(model, hp, seq, band_scorer(channels),
                                 code_values=code_values,
                                 n_draws=args.code_draws, seed=args.seed,
                                 code_dim=dim)  # (N_CODES, S, 2)
        per_band = {}
        for b, bname in enumerate(BAND_NAMES):
            stats = continuous_control_stats(
                code_values, levels[:, :, b], real_p5=real[b]["p5"],
                real_p95=real[b]["p95"], seed=args.seed)
            per_band[bname] = stats
            rho[dim, b] = stats["spearman"]
        control[f"dim{dim}"] = per_band

    # Disentanglement summary over the |rho| matrix: each dim's claimed
    # band is its argmax; the vector is identified iff the assignment is
    # injective and each dim's own-band knob dominates its cross-band
    # leakage (min margin > 0).
    assign = [int(np.argmax(np.abs(rho[d]))) for d in range(2)]
    margins = [float(np.abs(rho[d, assign[d]])
                     - np.abs(rho[d, 1 - assign[d]])) for d in range(2)]
    summary = {
        "rho_matrix": [[round(float(v), 4) for v in row] for row in rho],
        "assignment": assign,
        "injective": len(set(assign)) == 2,
        "own_band_rho": [round(float(rho[d, assign[d]]), 4)
                         for d in range(2)],
        "own_band_perm_p": [
            control[f"dim{d}"][BAND_NAMES[assign[d]]]["perm_p"]
            for d in range(2)],
        "margins": [round(m, 4) for m in margins],
        "min_margin": round(min(margins), 4),
    }

    # --- ATTRIBUTION MATRIX: random styles, both bands, same decodes ----
    grid = np.asarray(attribution_level_grid(
        model, hp, seq, channels, n_styles=args.n_styles,
        n_dropout=args.n_dropout, seed=args.seed))  # (N, M, 2)
    drawn = attribution_styles(hp, args.n_styles, args.seed,
                               model.device)[:, 0, :2].cpu().numpy()
    attribution = {
        f"dim{d}": {
            bname: round(float(sstats.spearmanr(
                np.repeat(drawn[:, d], args.n_dropout),
                grid[:, :, b].reshape(-1)).statistic), 4)
            for b, bname in enumerate(BAND_NAMES)}
        for d in range(2)}

    result = {
        "variant": args.variant,
        "hparams": dict(VARIANTS[args.variant]),
        "hparams_override": args.hparams,
        "iterations": iteration,
        "train_seconds": train_seconds,
        "seed": args.seed,
        "final_validation": final_val,
        "real_curves": {BAND_NAMES[b]: {k: v for k, v in real[b].items()
                                        if k not in ("u", "band_level")}
                        for b in range(2)},
        "control": control,
        "summary": summary,
        "attribution": attribution,
        "n_utts": args.n_utts,
        "analyze_only": args.analyze_only,
        "device": device_label(args.device),
    }
    with open(os.path.join(out, "vector_study.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    print_launches()
    return result


if __name__ == "__main__":
    main()
