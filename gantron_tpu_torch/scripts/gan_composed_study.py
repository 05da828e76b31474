"""The composed capstone (port of scripts/gan_composed_study.py): ONE model
delivering BOTH measured GAN values.

On ``data.toy.build_composed_corpus`` — a hidden mode bit on the [4.0,
4.8] kHz band AND i.i.d. per-frame texture >= 5.4 kHz, scored on disjoint
mel channel bands — each arm is scored for:

  * identification: the (N styles) x (M dropout streams) grid on the MODE
    band (``eval.sampling.attribution_level_grid``, the schedule
    mode_attribution uses) — within_noise_consistency + per-style chi^2
    vs the binomial dropout-only null
    (``eval.mode_study.attribution_grid_stats``);
  * texture: free-running texture_recovery on the TEXTURE band vs the real
    corpus anchor (``eval.mode_study.texture_stats``).

Writes ``<out>/<variant>[_s<seed>]/composed_study.json``.

Usage:
  python -m gantron_tpu_torch.scripts.gan_composed_study --variant full \
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

_BIT_WARM = {
    "adversarial_rollouts": True,
    "style_reconstruction_weight": 10.0,
    "diversity_weight": 1.0,
    "diversity_cap": 0.9,
    "style_code_dims": 1,
    "style_code_levels": 2,
    "identification_warmup": 1000,
}

VARIANTS = {
    # The composition: the identification campaign's best arm
    # (infogan_bit_warm) + the texture study's best D constraint (WGAN-GP
    # instead of the 0.001 weight clip).
    "full": dict(_BIT_WARM, gradient_penalty_lambda=10.0),
    # Ablation: identification without the gradient penalty.
    "bit_warm": dict(_BIT_WARM),
    # The MSE-only texture/identification floor.
    "nogan": {"d_freq": 0, "disc_warmp_up": 0},
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", choices=sorted(VARIANTS), default="full")
    parser.add_argument("-o", "--output",
                        default=default_root("composedstudy"))
    parser.add_argument("--iterations", type=int, default=3000)
    parser.add_argument("--n_utts", type=int, default=200)
    parser.add_argument("--samples", type=int, default=40,
                        help="free-running samples for the texture score")
    parser.add_argument("--n_styles", type=int, default=16)
    parser.add_argument("--n_dropout", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--hparams", type=str, default=None)
    parser.add_argument("--analyze_only", action="store_true")
    add_device_argument(parser)
    return parser.parse_args(argv)


def hparams_for(args, train_list, val_list):
    return study_hparams(args.iterations, dict(
        NOISE_STUDY, seed=4321 + args.seed,
        training_files=[train_list], validation_files=[val_list]),
        VARIANTS[args.variant], args.hparams)


def main(argv=None):
    args = parse_args(argv)

    from gantron_tpu_torch.data.toy import (MODEBAND_SCORE, TEXBAND_SCORE,
                                            build_composed_corpus)
    from gantron_tpu_torch.eval.mode_study import (attribution_grid_stats,
                                                   band_channels,
                                                   compute_real_anchors,
                                                   texture_stats)
    from gantron_tpu_torch.eval.sampling import (attribution_level_grid,
                                                 random_style)
    from gantron_tpu_torch.scripts.gan_texture_study import real_texture
    from gantron_tpu_torch.utils.device import generator
    from gantron_tpu_torch.utils.loading import load_generator

    corpus_root = corpus_dir(args.output, args.seed)
    os.makedirs(corpus_root, exist_ok=True)
    wav_dir, train_list, val_list, modes = build_composed_corpus(
        corpus_root, n_utts=args.n_utts, seed=args.seed)
    hp = hparams_for(args, train_list, val_list)

    out = arm_dir(args.output, args.variant, args.seed)
    iteration, train_seconds, final_val, ckpt_path = train_arm(
        out, args.variant, hp, wav_dir, args.analyze_only, args.device)

    mode_ch = band_channels(hp, *MODEBAND_SCORE)
    tex_ch = band_channels(hp, TEXBAND_SCORE)
    anchors = compute_real_anchors(train_list, wav_dir, modes, hp,
                                   channels=mode_ch, device=args.device)
    real_tex = real_texture(train_list, wav_dir, hp, tex_ch, args.device)

    model = load_generator(ckpt_path, hp, args.device)
    seq = study_sequence()

    # --- Identification: the (N styles) x (M dropout streams) grid on the
    # MODE band.
    levels = attribution_level_grid(model, hp, seq, mode_ch,
                                     n_styles=args.n_styles,
                                     n_dropout=args.n_dropout,
                                     seed=args.seed)
    attribution = attribution_grid_stats(levels, anchors["midpoint"])

    # --- Texture: free-running samples (independent noise draws) scored on
    # the TEXTURE band, as gan_texture_study scores them.
    smels, slengths = random_style(
        model, seq, args.samples,
        generator=generator(model.device, 7 + args.seed),
        max_decoder_steps=hp.max_decoder_steps)
    gen_tex = texture_stats(
        [(smels[i], slengths[i]) for i in range(smels.shape[0])], tex_ch)

    result = {
        "variant": args.variant,
        "hparams": dict(VARIANTS[args.variant]),
        "hparams_override": args.hparams,
        "iterations": iteration,
        "train_seconds": train_seconds,
        "seed": args.seed,
        "final_validation": final_val,
        "mode_anchors": anchors,
        "identification": attribution,
        "texture_real": real_tex,
        "texture_generated": gen_tex,
        "texture_recovery": round(
            gen_tex["temporal_std"] / max(real_tex["temporal_std"], 1e-9),
            4),
        "n_utts": args.n_utts,
        "analyze_only": args.analyze_only,
        "device": device_label(args.device),
    }
    with open(os.path.join(out, "composed_study.json"), "w") as f:
        json.dump(result, f, indent=2)
    brief = {k: v for k, v in result.items()
             if k not in ("identification", "texture_real",
                          "texture_generated", "mode_anchors")}
    brief["identification"] = {
        k: v for k, v in attribution.items()
        if k not in ("level_grid", "per_style_hi_counts")}
    brief["texture_generated_std"] = gen_tex["temporal_std"]
    brief["texture_real_std"] = real_tex["temporal_std"]
    print(json.dumps(brief, indent=2))
    print_launches()
    return result


if __name__ == "__main__":
    main()
