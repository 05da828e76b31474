"""Per-frame sharpness study (port of scripts/gan_texture_study.py): does
the adversarial loss buy TEXTURE where MSE must blur?

On ``data.toy.build_texture_corpus`` the high-band amplitude is redrawn
i.i.d. EVERY mel frame — unpredictable from text and all history — so the
MSE-optimal free-running generator outputs the flat conditional mean
(within-utterance high-band temporal std ~0) while the real corpus has a
large, known spread. Each variant trains the same architecture and its
free-running samples are scored with ``eval.mode_study.texture_stats``
against the real-corpus anchor. Writes
``<out>/<variant>[_s<seed>]/texture_study.json``.

Usage:
  python -m gantron_tpu_torch.scripts.gan_texture_study --variant gan \
      [-o DIR] [--device cpu]
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
    "gan": {},
    "nogan": {"d_freq": 0, "disc_warmp_up": 0},
    "rollout": {"adversarial_rollouts": True},
    # D-side knobs the reference ships but never measures
    # (hparams.py:93-102), each asked "does it recover more of the
    # unpredictable per-frame texture?".
    # WGAN-GP instead of the 0.001 weight clip: a softer Lipschitz
    # constraint, so D keeps more capacity to see texture statistics.
    "gp": {"gradient_penalty_lambda": 10.0},
    "gp_rollout": {"gradient_penalty_lambda": 10.0,
                   "adversarial_rollouts": True},
    # The reference's second discriminator family (model.py:543-583).
    "lindisc": {"discriminator_type": "linear"},
    # Finer windows: 10-frame scores give D ~2x more views per utterance of
    # the per-frame statistic.
    "win10": {"discriminator_window": 10},
    # Twice the D steps per G/D cycle.
    "gan_d2": {"d_freq": 2},
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", choices=sorted(VARIANTS), default="gan")
    parser.add_argument("-o", "--output", default=default_root("texstudy"))
    parser.add_argument("--iterations", type=int, default=3000)
    parser.add_argument("--n_utts", type=int, default=200)
    parser.add_argument("--samples", type=int, default=40,
                        help="free-running samples (independent noise draws)")
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


def real_texture(train_list, wav_dir, hp, channels, device):
    """``texture_stats`` of the training corpus's mels, through the SAME
    cached extraction the run trained on."""
    from gantron_tpu_torch.data.dataset import TextMelDataset
    from gantron_tpu_torch.eval.mode_study import texture_stats

    ds = TextMelDataset([train_list], hp, wav_dir, device=device)
    with open(train_list) as f:
        names = [line.split("|")[0] for line in f if line.strip()]
    real = []
    for name in names:
        mel = ds.get_mel(os.path.join(wav_dir, name))
        real.append((mel, mel.shape[1]))
    return texture_stats(real, channels)


def main(argv=None):
    args = parse_args(argv)

    from gantron_tpu_torch.data.toy import build_texture_corpus
    from gantron_tpu_torch.eval.mode_study import (hiband_channels,
                                                   texture_stats)
    from gantron_tpu_torch.eval.sampling import random_style
    from gantron_tpu_torch.utils.device import generator
    from gantron_tpu_torch.utils.loading import load_generator

    corpus_root = corpus_dir(args.output, args.seed)
    os.makedirs(corpus_root, exist_ok=True)
    wav_dir, train_list, val_list = build_texture_corpus(
        corpus_root, n_utts=args.n_utts, seed=args.seed)
    hp = hparams_for(args, train_list, val_list)

    out = arm_dir(args.output, args.variant, args.seed)
    iteration, train_seconds, final_val, ckpt_path = train_arm(
        out, args.variant, hp, wav_dir, args.analyze_only, args.device)

    channels = hiband_channels(hp)
    real_stats = real_texture(train_list, wav_dir, hp, channels, args.device)

    model = load_generator(ckpt_path, hp, args.device)
    mels, lengths = random_style(
        model, study_sequence(), args.samples,
        generator=generator(model.device, 7 + args.seed),
        max_decoder_steps=hp.max_decoder_steps)
    gen_stats = texture_stats(
        [(mels[i], lengths[i]) for i in range(mels.shape[0])], channels)

    result = {
        "variant": args.variant,
        "hparams": dict(VARIANTS[args.variant]),
        "hparams_override": args.hparams,
        "iterations": iteration,
        "train_seconds": train_seconds,
        "final_validation": final_val,
        "real": real_stats,
        "generated": gen_stats,
        # The headline: fraction of the real within-utterance texture spread
        # the generator reproduces (1.0 = real-like, ~0 = MSE-flat).
        "texture_recovery": round(
            gen_stats["temporal_std"] / max(real_stats["temporal_std"],
                                            1e-9), 4),
        "n_utts": args.n_utts,
        "seed": args.seed,
        "analyze_only": args.analyze_only,
        "device": device_label(args.device),
    }
    with open(os.path.join(out, "texture_study.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    print_launches()
    return result


if __name__ == "__main__":
    main()
