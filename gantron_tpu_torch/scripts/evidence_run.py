"""Trained-checkpoint controllability evidence (port of
scripts/evidence_run.py): train one variant of a small GANtron on the
emotive tone corpus, then run the FULL study_model pipeline (generate
forced-emotion groups -> Griffin-Lim vocode -> re-extract classifier mels
-> train a fresh group classifier) on the resulting checkpoint and record
group-classification accuracy + generation error rate (the reference's
headline controllability metrics, study_model.py:142-197), an unsupervised
k-means split of the generated mels and the open-loop alignment quality.

Variants:
  gan    d_freq=1 (adversarial training on)      -- the main evidence run
  nogan  d_freq=0 (plain Tacotron2-style)        -- GAN on/off comparison
  k2/k4  n_frames_per_step=2/4 + GAN             -- K quality/throughput study
  full_identified  labels + noise + the identification stack

Each variant writes <out>/<variant>/evidence.json. Usage:
  python -m gantron_tpu_torch.scripts.evidence_run --variant gan \
      [-o DIR] [--device cpu]
"""

import argparse
import json
import os
import time

from gantron_tpu_torch.scripts._study_common import (STUDY_TEXT,
                                                     add_device_argument,
                                                     default_root,
                                                     device_label,
                                                     print_launches,
                                                     study_hparams, train_arm)

VARIANTS = {
    "gan": {},
    "nogan": {"d_freq": 0, "disc_warmp_up": 0},
    "k2": {"n_frames_per_step": 2},
    "k4": {"n_frames_per_step": 4},
    # The reference's "Full GANtron" shape (labels + noise, README.md:26-33)
    # composed with the identification stack the mode study validated
    # (gan_mode_study infogan_bit_warm): do the emotion-controllability
    # gates survive an IDENTIFIED latent riding alongside the labels?
    "full_identified": {"use_noise": True, "noise_size": 32,
                        "adversarial_rollouts": True,
                        "style_reconstruction_weight": 10.0,
                        "diversity_weight": 1.0, "diversity_cap": 0.9,
                        "style_code_dims": 1, "style_code_levels": 2,
                        "identification_warmup": 1000},
}


def mel_sharpness(mel_dir):
    """Mean squared temporal difference of generated mels — adversarial
    training should resist the MSE-loss blur (higher = sharper)."""
    import numpy as np

    vals = []
    for p in sorted(os.listdir(mel_dir)):
        if not p.endswith(".npy"):
            continue
        m = np.load(os.path.join(mel_dir, p), allow_pickle=True)
        if m.ndim == 3:
            m = m[0]
        if m.shape[1] >= 2:
            vals.append(float(np.mean(np.diff(m, axis=1) ** 2)))
    return float(sum(vals) / max(len(vals), 1))


def kmeans_on_study(mel_dir, device="cuda"):
    """Unsupervised separability of the study's generated mels (reference
    check_kmeans.py, via eval.clustering, k-means on ``device``): group id
    parsed from the ``{g}-{i}-...`` simple_name files, same featurization
    as the reference loader (common-length prefix, flattened,
    max-normalized)."""
    import numpy as np

    from gantron_tpu_torch.eval.clustering import check_kmeans_accuracy

    mels, gids = [], []
    for p in sorted(os.listdir(mel_dir)):
        if not p.endswith(".npy"):
            continue
        m = np.load(os.path.join(mel_dir, p), allow_pickle=True)
        if m.ndim == 3:
            m = m[0]
        mels.append(m)
        gids.append(int(p.split("-")[0]))
    min_len = min(m.shape[1] for m in mels)
    max_val = max(max(abs(float(m.min())), abs(float(m.max())))
                  for m in mels)
    rows = np.stack([m[:, :min_len].flatten() / max_val for m in mels])
    basic, best, perm = check_kmeans_accuracy(rows, np.asarray(gids),
                                              device=device)
    return {"basic_accuracy": round(basic, 4),
            "best_accuracy": round(best, 4),
            "n_samples": len(gids), "n_frames": int(min_len)}


def alignment_check(model, hp, text, n_groups, batch=8, seed=1):
    """Attention-alignment quality of open-loop decoding, per forced-emotion
    group: focus (mean max attention weight per frame), monotonicity
    (fraction of frames whose argmax does not move backward), and coverage
    (fraction of text positions that win at least one frame's argmax).
    Group g's prenet dropout draws from seed ``seed + 2g``, its noise from
    ``seed + 2g + 1``."""
    import numpy as np
    import torch

    from gantron_tpu_torch.eval.sampling import INT_EMOTIONS
    from gantron_tpu_torch.text import text_to_sequence
    from gantron_tpu_torch.utils.device import generator

    device = model.device
    seq = torch.as_tensor(text_to_sequence(text, ["english_cleaners"]),
                          dtype=torch.long, device=device)
    seq = seq[None].expand(batch, seq.shape[0])
    spk = torch.zeros((batch,), dtype=torch.long, device=device)
    focus, mono, cover = [], [], []
    for g in range(n_groups):
        emo = torch.as_tensor(INT_EMOTIONS[g], device=device)[None] \
            .expand(batch, 5)
        out = model.infer(seq, None, emo, spk, hp.max_decoder_steps,
                          generator=generator(device, seed + 2 * g),
                          noise_generator=generator(device, seed + 2 * g + 1))
        align = out[3].cpu().numpy()  # (B, S, T_in): one row per STEP
        lengths = out[4].cpu().numpy()
        T = align.shape[2]
        # The lengths are in frames (= steps * K); the alignment has one row
        # per decoder step, so slice in STEP units — else every K>1
        # sample's metrics would include post-gate-stop attention rows.
        K = int(hp.n_frames_per_step or 1)
        for i in range(batch):
            L = max(-(-int(lengths[i]) // K), 1)
            a = align[i, :L]
            arg = a.argmax(axis=1)
            focus.append(float(a.max(axis=1).mean()))
            mono.append(float(np.mean(np.diff(arg) >= 0)) if L > 1 else 1.0)
            cover.append(len(set(arg.tolist())) / T)
    return {"focus": round(float(np.mean(focus)), 4),
            "monotonicity": round(float(np.mean(mono)), 4),
            "coverage": round(float(np.mean(cover)), 4),
            "n": len(focus)}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", choices=sorted(VARIANTS), default="gan")
    parser.add_argument("-o", "--output", default=default_root("evidence"))
    parser.add_argument("--iterations", type=int, default=3000)
    parser.add_argument("--n_utts", type=int, default=300)
    parser.add_argument("--samples", type=int, default=20,
                        help="study samples per emotion group")
    parser.add_argument("--classifier_epochs", type=int, default=40)
    parser.add_argument("--hparams", type=str, default=None)
    add_device_argument(parser)
    # run_study gives every arm --seed; this study has no replication seed
    # (its corpus and runs are seeded by the configuration), so only 0.
    parser.add_argument("--seed", type=int, default=0,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.seed != 0:
        parser.error(f"--seed {args.seed}: evidence_run has no replication "
                     "seed; use 0")
    return args


def hparams_for(args, vesus_root, lj_empty, train_list, val_list):
    return study_hparams(args.iterations, dict(
        speakers_embedding=16, n_labels=5,
        use_noise=False, noise_size=0,
        use_labels=True, use_intended_labels=True, vesus_path=vesus_root,
        training_files=[lj_empty, train_list],
        validation_files=[lj_empty, val_list]),
        VARIANTS[args.variant], args.hparams)


def main(argv=None):
    args = parse_args(argv)

    from gantron_tpu_torch.config import ClassifierHParams
    from gantron_tpu_torch.data.toy import build_emotive_corpus
    from gantron_tpu_torch.eval.study import study_model
    from gantron_tpu_torch.utils.loading import load_generator

    # Corpus is shared across variants (same seed -> same wavs/filelists).
    corpus_root = os.path.join(args.output, "corpus")
    os.makedirs(corpus_root, exist_ok=True)
    vesus_root, lj_empty, train_list, val_list = build_emotive_corpus(
        corpus_root, n_utts=args.n_utts)
    hp = hparams_for(args, vesus_root, lj_empty, train_list, val_list)

    out = os.path.join(args.output, args.variant)
    t0 = time.time()
    iteration, _, final_val, ckpt_path = train_arm(
        out, args.variant, hp, corpus_root + os.sep, False, args.device)
    train_seconds = time.time() - t0
    steps_per_sec = iteration / max(train_seconds, 1e-9)

    # Study on the trained checkpoint: forced one-hot emotion groups
    # (int_labels), no noise forcing.
    model = load_generator(ckpt_path, hp, args.device)
    study_dir = os.path.join(out, "study")
    hpc = ClassifierHParams()
    # Toy utterances are ~30-54 frames; crop within them.
    hpc.add_params(dict(n_frames=24, batch_size=16))
    study = study_model(
        study_dir, model, hp, text=STUDY_TEXT, n_groups=5,
        samples=args.samples, int_labels=True, predefined=False,
        force_emotions=True, force_noise=False,
        classifier_epochs=args.classifier_epochs, seed=0,
        log_fn=print, classifier_hp=hpc)
    study.pop("history", None)

    # The K decision cites the classifier study AND an unsupervised k-means
    # split AND alignment quality, all on the same trained checkpoint.
    mel_dir = os.path.join(study_dir, "GANtronInference")
    kmeans = kmeans_on_study(mel_dir, device=model.device)
    alignment = alignment_check(model, hp, STUDY_TEXT, n_groups=5)

    result = {
        "variant": args.variant,
        "hparams": dict(VARIANTS[args.variant]),
        "iterations": iteration,
        "train_seconds": round(train_seconds, 1),
        "train_steps_per_sec": round(steps_per_sec, 2),
        "final_validation": final_val,
        "study": study,
        "check_kmeans": kmeans,
        "alignment": alignment,
        "generated_mel_sharpness": mel_sharpness(mel_dir),
        "n_utts": args.n_utts,
        "device": device_label(args.device),
    }
    with open(os.path.join(out, "evidence.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    print_launches()
    return result


if __name__ == "__main__":
    main()
