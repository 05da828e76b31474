"""Noise-vs-dropout mode attribution on a trained mode-study checkpoint
(port of scripts/mode_attribution.py).

A free-running GANtron sample has TWO randomness sources: the injected
noise/style vector (the designed latent, reference model.py:184-191,
273-279) and the always-on prenet dropout (reference model.py:104). This
instrument separates them on an existing checkpoint: an N x M grid of
(noise style i, dropout stream j) decodes of the same text
(``eval.sampling.attribution_level_grid``), where along j only dropout
varies and along i only the latent varies, scored by
``eval.mode_study.attribution_grid_stats``:

  * within_noise_consistency: mean over styles of the majority-mode fraction
    across the M dropout draws (1.0 = the latent fully determines the mode);
  * noise_mode_split: how many of the N latents map to each mode;
  * the per-style chi^2 against the binomial dropout-only null.

Writes ``mode_attribution.json`` (``--select best``:
``mode_attribution_best.json``; ``--probe``:
``mode_attribution_probe_<iter>.json``) into the run directory.

Usage:
  python -m gantron_tpu_torch.scripts.mode_attribution \
      --run_dir DIR/gan_s1 --variant gan --iterations 3000 \
      [--n_styles 16 --n_dropout 8] [--device cpu]
"""

import argparse
import json
import os

from gantron_tpu_torch.scripts._study_common import (NOISE_STUDY,
                                                     add_device_argument,
                                                     checkpoint_iteration,
                                                     corpus_dir, device_label,
                                                     print_launches,
                                                     study_hparams,
                                                     study_sequence)
from gantron_tpu_torch.scripts.gan_mode_study import VARIANTS


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--run_dir", required=True,
                        help="a gan_mode_study output dir (checkpoint + "
                             "mode_study.json with real_anchors)")
    # Any mode-study variant: they share the inference architecture, but
    # recording the true variant keeps the artifact's provenance straight.
    parser.add_argument("--variant", default="gan",
                        choices=tuple(sorted(VARIANTS)))
    parser.add_argument("--iterations", type=int, default=3000,
                        help="must match the training run (schedule-derived "
                             "hparams feed the model config)")
    parser.add_argument("--n_styles", type=int, default=16)
    parser.add_argument("--n_dropout", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--hparams", type=str, default=None,
                        help="must repeat any --hparams the training run "
                             "used (e.g. n_frames_per_step=2); "
                             "quantized_inference=True decodes with the "
                             "int8 recurrence matrices")
    add_device_argument(parser)
    parser.add_argument("--probe", action="store_true",
                        help="mid-run probe of a LIVE training run: score "
                             "the newest periodic checkpoint and write "
                             "mode_attribution_probe_<iter>.json instead of "
                             "the final artifact (anchors are recomputed "
                             "from the corpus when mode_study.json does not "
                             "exist yet)")
    parser.add_argument("--n_utts", type=int, default=200,
                        help="corpus size for the anchor recomputation "
                             "fallback (must match the training run)")
    parser.add_argument("--select", choices=("latest", "best"),
                        default="latest",
                        help="'best' scores the checkpoint keep-best "
                             "retention preserved (lowest val loss on "
                             "disk) instead of the run's endpoint")
    return parser.parse_args(argv)


def hparams_for(args):
    return study_hparams(args.iterations, NOISE_STUDY,
                         VARIANTS[args.variant], args.hparams)


def main(argv=None):
    args = parse_args(argv)

    from gantron_tpu_torch.eval.mode_study import (attribution_grid_stats,
                                                   hiband_channels)
    from gantron_tpu_torch.eval.sampling import attribution_level_grid
    from gantron_tpu_torch.train.checkpoint import CheckpointManager
    from gantron_tpu_torch.utils.loading import load_generator

    hp = hparams_for(args)
    study_json = os.path.join(args.run_dir, "mode_study.json")
    if os.path.exists(study_json):
        with open(study_json) as f:
            anchors = json.load(f)["real_anchors"]
    else:
        # Mid-run probe before gan_mode_study has written its artifact:
        # recompute the real-mode anchors from the (deterministic, seeded)
        # corpus — the same extraction the run trains on.
        # build_bimodal_corpus is read-safe next to a live run: existing
        # wavs are never rewritten and filelist writes are atomic; it runs
        # here only to reconstruct the seeded ``modes`` map.
        from gantron_tpu_torch.data.toy import build_bimodal_corpus
        from gantron_tpu_torch.eval.mode_study import compute_real_anchors

        wav_dir, train_list, _, modes = build_bimodal_corpus(
            corpus_dir(os.path.dirname(os.path.abspath(args.run_dir)),
                       args.seed),
            n_utts=args.n_utts, seed=args.seed)
        anchors = compute_real_anchors(train_list, wav_dir, modes, hp,
                                       device=args.device)
    midpoint = anchors["midpoint"]

    manager = CheckpointManager(args.run_dir)
    ckpt_path = manager.best() if args.select == "best" else manager.latest()
    if ckpt_path is None:
        raise FileNotFoundError(f"no checkpoint in {args.run_dir}")
    model = load_generator(ckpt_path, hp, args.device)
    levels = attribution_level_grid(
        model, hp, study_sequence(), hiband_channels(hp),
        n_styles=args.n_styles, n_dropout=args.n_dropout, seed=args.seed)

    result = {
        "run_dir": args.run_dir,
        "variant": args.variant,
        "hparams_override": args.hparams,
        "checkpoint": os.path.basename(ckpt_path),
        "selection": args.select,
        **attribution_grid_stats(levels, midpoint),
        "anchors": anchors,
        "device": device_label(args.device),
    }
    name = ("mode_attribution.json" if args.select == "latest"
            else "mode_attribution_best.json")
    if args.probe:
        it = checkpoint_iteration(ckpt_path)
        result["probe_iteration"] = it
        name = f"mode_attribution_probe_{it}.json"
    with open(os.path.join(args.run_dir, name), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("level_grid", "per_style_hi_counts")},
                     indent=2))
    print_launches()
    return result


if __name__ == "__main__":
    main()
