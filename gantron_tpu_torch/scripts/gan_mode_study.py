"""One-to-many mode-commitment study (port of scripts/gan_mode_study.py):
does the adversarial loss + injected noise let the generator COMMIT to a
mode where MSE regresses to the mean?

On ``data.toy.build_bimodal_corpus`` each utterance randomly carries (mode
hi) or lacks (mode lo) a >=5 kHz noise texture hidden from text/labels, so
p(mel | text) is bimodal. The MSE-optimal free-running generator outputs
the blurred conditional mean between the modes; a working GAN uses its
noise vector to land on a real mode per draw. Each variant trains the same
architecture (noise path present in all) and its free-running samples are
scored with ``eval.mode_study.commitment_stats`` against the real modes'
anchors. Writes ``<out>/<variant>[_s<seed>]/mode_study.json``.

Usage:
  python -m gantron_tpu_torch.scripts.gan_mode_study --variant gan \
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
    # Free-running adversarial rollouts: D scores (and trains against) the
    # open-loop sampling distribution instead of teacher-forced outputs —
    # the lever the mode-attribution study motivates (the teacher-forced GAN
    # leaves the latent unused; see docs/TRAINING_EVIDENCE.md).
    "rollout": {"adversarial_rollouts": True},
    # Rollouts + InfoGAN-style latent identification: a StyleEncoder head
    # reconstructs the injected style from the rollout mel and the error
    # joins the G loss.
    "infogan": {"adversarial_rollouts": True,
                "style_reconstruction_weight": 10.0},
    # Q head + diversity-sensitive regularizer (config.py diversity_weight):
    # the Q head alone sits at a cold-start saddle; the DS term's gradient
    # is nonzero exactly there.
    "infogan_ds": {"adversarial_rollouts": True,
                   "style_reconstruction_weight": 10.0,
                   "diversity_weight": 1.0},
    # 2-dim InfoGAN code + RATIO-clamped diversity (tau=3): the measured
    # "watermark" failure, kept as the ablation arm for infogan_sat.
    "infogan_code": {"adversarial_rollouts": True,
                     "style_reconstruction_weight": 10.0,
                     "diversity_weight": 0.5,
                     "diversity_tau": 3.0,
                     "style_code_dims": 2},
    # 2-dim code, diversity contrasting only code redraws, and the reward
    # saturating in OUTPUT units (config.py diversity_cap).
    "infogan_sat": {"adversarial_rollouts": True,
                    "style_reconstruction_weight": 10.0,
                    "diversity_weight": 1.0,
                    "diversity_cap": 0.9,
                    "style_code_dims": 2},
    # infogan_sat + identification warm-up (config.py
    # identification_warmup): the first third runs as the stable rollout
    # GAN, then the Q head + saturating diversity switch on.
    "infogan_warm": {"adversarial_rollouts": True,
                     "style_reconstruction_weight": 10.0,
                     "diversity_weight": 1.0,
                     "diversity_cap": 0.9,
                     "style_code_dims": 2,
                     "identification_warmup": 1000},
    # A 2-level discrete code (config.py style_code_levels; InfoGAN's
    # categorical form), exactly satisfiable by flipping real modes.
    "infogan_bit": {"adversarial_rollouts": True,
                    "style_reconstruction_weight": 10.0,
                    "diversity_weight": 1.0,
                    "diversity_cap": 0.9,
                    "style_code_dims": 1,
                    "style_code_levels": 2},
    # The discrete code + the warm-up, composed.
    "infogan_bit_warm": {"adversarial_rollouts": True,
                         "style_reconstruction_weight": 10.0,
                         "diversity_weight": 1.0,
                         "diversity_cap": 0.9,
                         "style_code_dims": 1,
                         "style_code_levels": 2,
                         "identification_warmup": 1000},
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", choices=sorted(VARIANTS), default="gan")
    parser.add_argument("-o", "--output", default=default_root("modestudy"))
    parser.add_argument("--iterations", type=int, default=3000)
    parser.add_argument("--n_utts", type=int, default=200)
    parser.add_argument("--samples", type=int, default=80,
                        help="free-running samples (independent noise draws)")
    parser.add_argument("--seed", type=int, default=0,
                        help="replication seed: shifts the corpus draw, the "
                             "training seed, and the sampling seed together")
    parser.add_argument("--hparams", type=str, default=None)
    parser.add_argument("--analyze_only", action="store_true",
                        help="skip training: score the newest checkpoint "
                             "already in the output dir (also works on a "
                             "PARTIAL run's periodic checkpoints)")
    add_device_argument(parser)
    return parser.parse_args(argv)


def hparams_for(args, train_list, val_list):
    return study_hparams(args.iterations, dict(
        NOISE_STUDY, seed=1234 + args.seed,
        training_files=[train_list], validation_files=[val_list]),
        VARIANTS[args.variant], args.hparams)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np

    from gantron_tpu_torch.data.toy import build_bimodal_corpus
    from gantron_tpu_torch.eval.mode_study import (commitment_stats,
                                                   compute_real_anchors,
                                                   hiband_channels,
                                                   hiband_level)
    from gantron_tpu_torch.eval.sampling import random_style
    from gantron_tpu_torch.utils.device import generator
    from gantron_tpu_torch.utils.loading import load_generator

    corpus_root = corpus_dir(args.output, args.seed)
    os.makedirs(corpus_root, exist_ok=True)
    wav_dir, train_list, val_list, modes = build_bimodal_corpus(
        corpus_root, n_utts=args.n_utts, seed=args.seed)
    hp = hparams_for(args, train_list, val_list)

    out = arm_dir(args.output, args.variant, args.seed)
    iteration, train_seconds, final_val, ckpt_path = train_arm(
        out, args.variant, hp, wav_dir, args.analyze_only, args.device)

    # Real-mode anchors from the training mels, via the SAME extraction the
    # dataset trained on (cached next to the wavs).
    anchors = compute_real_anchors(train_list, wav_dir, modes, hp,
                                   device=args.device)
    channels = hiband_channels(hp)

    # Free-running generation: one text, `samples` independent noise draws.
    model = load_generator(ckpt_path, hp, args.device)
    mels, lengths = random_style(
        model, study_sequence(), args.samples,
        generator=generator(model.device, 7 + args.seed),
        max_decoder_steps=hp.max_decoder_steps)
    gen_levels, sharp = [], []
    for i in range(mels.shape[0]):
        m = mels[i, :, : max(int(lengths[i]), 2)]
        gen_levels.append(hiband_level(m, channels))
        sharp.append(float(np.mean(np.diff(m, axis=1) ** 2)))
    stats = commitment_stats(gen_levels, anchors)

    result = {
        "variant": args.variant,
        "hparams": dict(VARIANTS[args.variant]),
        "hparams_override": args.hparams,
        "iterations": iteration,
        "train_seconds": train_seconds,
        "final_validation": final_val,
        "real_anchors": {k: round(v, 3) for k, v in anchors.items()},
        "generated": stats,
        "generated_mel_sharpness": float(np.mean(sharp)),
        "n_utts": args.n_utts,
        "seed": args.seed,
        "analyze_only": args.analyze_only,
        "device": device_label(args.device),
    }
    with open(os.path.join(out, "mode_study.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    print_launches()
    return result


if __name__ == "__main__":
    main()
