"""Continuous latent control (port of scripts/gan_continuous_study.py): is
the noise vector a monotone KNOB?

``data.toy.build_leveled_corpus`` hides one CONTINUOUS factor (a [4.0,
4.8] kHz marker whose amplitude sweeps 18 dB log-uniformly with u ~ U(0,
1), hidden from text/labels); the arms ask whether a 1-dim continuous code
becomes a monotone control knob for it:

  * CONTROL — sweep the code dim over [0.05, 0.95] with shared nuisance
    draws (``eval.calibration.measure_knob``, the campaign's sweep
    protocol) and score the decoded band level
    (``eval.mode_study.continuous_control_stats``);
  * ATTRIBUTION — the random-style grid
    (``eval.sampling.attribution_level_grid``): Spearman between the DRAWN
    style's code-dim value and the decoded level;
  * FIDELITY — final validation losses.

Writes ``<out>/<variant>[_s<seed>]/continuous_study.json`` (with the real
curve's per-utterance values; the printed result leaves them out).

Usage:
  python -m gantron_tpu_torch.scripts.gan_continuous_study \
      --variant cont_warm --seed 0 [-o DIR] [--device cpu]
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

_WARM = {
    "adversarial_rollouts": True,
    "style_reconstruction_weight": 10.0,
    "diversity_weight": 1.0,
    "diversity_cap": 0.9,
    "identification_warmup": 1000,
    "validation_sample_diversity": 8,
    "style_code_dims": 1,
}

VARIANTS = {
    "nogan": {"d_freq": 0, "disc_warmp_up": 0},
    "rollout": {"adversarial_rollouts": True},
    # Continuous 1-dim code: topology-matched to the hidden continuum.
    "cont_warm": dict(_WARM, style_code_levels=0),
    # The discrete-knob comparison: 4 levels facing the same continuum.
    "cont_bit4": dict(_WARM, style_code_levels=4),
}

N_CODES = 11
CODE_LO, CODE_HI = 0.05, 0.95


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", choices=sorted(VARIANTS),
                        default="cont_warm")
    parser.add_argument("-o", "--output",
                        default=default_root("continuousstudy"))
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
        NOISE_STUDY, seed=5321 + args.seed,
        training_files=[train_list], validation_files=[val_list]),
        VARIANTS[args.variant], args.hparams)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np

    from gantron_tpu_torch.data.toy import (MODEBAND_SCORE,
                                            build_leveled_corpus)
    from gantron_tpu_torch.eval.calibration import measure_knob
    from gantron_tpu_torch.eval.mode_study import (band_channels,
                                                   compute_real_levels,
                                                   continuous_control_stats,
                                                   hiband_level)
    from gantron_tpu_torch.eval.sampling import (attribution_level_grid,
                                                 attribution_styles)
    from gantron_tpu_torch.utils.loading import load_generator

    corpus_root = corpus_dir(args.output, args.seed)
    os.makedirs(corpus_root, exist_ok=True)
    wav_dir, train_list, val_list, levels_by_name = build_leveled_corpus(
        corpus_root, n_utts=args.n_utts, seed=args.seed)
    hp = hparams_for(args, train_list, val_list)

    out = arm_dir(args.output, args.variant, args.seed)
    iteration, train_seconds, final_val, ckpt_path = train_arm(
        out, args.variant, hp, wav_dir, args.analyze_only, args.device)

    channels = band_channels(hp, *MODEBAND_SCORE)
    real = compute_real_levels(train_list, wav_dir, levels_by_name, hp,
                               channels=channels, device=args.device)

    model = load_generator(ckpt_path, hp, args.device)
    seq = study_sequence()

    # --- CONTROL: sweep the code dim with shared nuisance draws ---------
    code_values, sweep_levels = measure_knob(
        model, hp, seq, lambda mel: hiband_level(mel, channels),
        code_values=np.linspace(CODE_LO, CODE_HI, N_CODES),
        n_draws=args.code_draws, seed=args.seed)
    control = continuous_control_stats(code_values, sweep_levels,
                                       real_p5=real["p5"],
                                       real_p95=real["p95"],
                                       seed=args.seed)

    # --- ATTRIBUTION: the shared random-style grid, scored continuously,
    # against each row's drawn code-dim value.
    grid = attribution_level_grid(model, hp, seq, channels,
                                  n_styles=args.n_styles,
                                  n_dropout=args.n_dropout, seed=args.seed)
    drawn = attribution_styles(hp, args.n_styles, args.seed,
                               model.device)[:, 0, 0].cpu().numpy()
    attribution = continuous_control_stats(drawn, np.asarray(grid),
                                           real_p5=real["p5"],
                                           real_p95=real["p95"],
                                           seed=args.seed)

    result = {
        "variant": args.variant,
        "hparams": dict(VARIANTS[args.variant]),
        "hparams_override": args.hparams,
        "iterations": iteration,
        "train_seconds": train_seconds,
        "seed": args.seed,
        "final_validation": final_val,
        "real_curve": {k: v for k, v in real.items()
                       if k not in ("u", "band_level")},
        "control": control,
        "attribution": attribution,
        "n_utts": args.n_utts,
        "analyze_only": args.analyze_only,
        "device": device_label(args.device),
    }
    with open(os.path.join(out, "continuous_study.json"), "w") as f:
        json.dump(dict(result, real_curve=real), f, indent=2)
    print(json.dumps(result, indent=2))
    print_launches()
    return result


if __name__ == "__main__":
    main()
