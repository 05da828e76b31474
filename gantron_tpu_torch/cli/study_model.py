"""End-to-end model study CLI of the PyTorch port (counterpart of the root
``study_model.py``; reference: study_model.py:200-229).

    python -m gantron_tpu_torch.cli.study_model -g out/iter=...ckpt \
        -o study/ --samples 10 --n_groups 6 [--device cpu]

Generates forced-style samples from a port checkpoint, vocodes them
(WaveGlow with ``-w``, else Griffin-Lim), re-extracts classifier mels,
trains a classifier on the group ids and reports the controllability
accuracy and the generation error rate, on the CUDA card unless
``--device cpu`` is given. Writes ``study_metrics.json``.
"""

import argparse
import json
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-g", "--gantron_path", type=str, required=True)
    parser.add_argument("-w", "--waveglow_path", type=str, default=None,
                        help="WaveGlow checkpoint (Griffin-Lim if absent)")
    parser.add_argument("-o", "--output_path", type=str, required=True)
    parser.add_argument("--samples", type=int, default=10)
    parser.add_argument("--waveglow_bs", type=int, default=8)
    parser.add_argument("--hparams", type=str, required=False)
    parser.add_argument("--notes", type=str, default="")
    parser.add_argument("--speaker", default=0, type=int)
    parser.add_argument("--n_groups", default=6, type=int)
    parser.add_argument("--force_emotions", default=None, type=str)
    parser.add_argument("--predefined", default="true", type=str)
    parser.add_argument("--force_noise", default=None, type=str)
    parser.add_argument("--int_labels", action="store_true")
    parser.add_argument("--classifier_epochs", type=int, default=100)
    parser.add_argument("--classifier_hparams", type=str, default=None,
                        help="k=v,k=v overrides for the study classifier "
                             "(e.g. n_frames=24 for short corpora)")
    parser.add_argument("--text", type=str,
                        default="Emotional speech synthesis")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run the study on")
    return parser.parse_args(argv)


def str2bool(v):
    if v is None:
        return None
    return str(v).lower() in ("yes", "true", "t", "y", "1")


def main(argv=None):
    args = parse_args(argv)

    from gantron_tpu_torch.config import ClassifierHParams, HParams
    from gantron_tpu_torch.eval.study import study_model
    from gantron_tpu_torch.utils.loading import load_generator

    os.makedirs(args.output_path, exist_ok=True)
    hp = HParams.create(args.hparams)
    hp.add_params(args)
    if not hp.use_noise:
        hp.noise_size = 0

    model = load_generator(args.gantron_path, hp, args.device)
    waveglow = None
    if args.waveglow_path:
        from gantron_tpu_torch.models.waveglow import load_waveglow

        waveglow = load_waveglow(args.waveglow_path, device=args.device)

    metrics = study_model(
        args.output_path, model, hp, text=args.text,
        n_groups=args.n_groups, samples=args.samples,
        predefined=str2bool(args.predefined),
        force_emotions=str2bool(args.force_emotions),
        force_noise=str2bool(args.force_noise), int_labels=args.int_labels,
        waveglow=waveglow, classifier_epochs=args.classifier_epochs,
        seed=args.seed, log_fn=lambda r: print(r), speaker=args.speaker,
        waveglow_bs=args.waveglow_bs,
        classifier_hp=(ClassifierHParams.create(args.classifier_hparams)
                       if args.classifier_hparams else None))

    print(json.dumps({k: v for k, v in metrics.items() if k != "history"},
                     indent=2))
    with open(os.path.join(args.output_path, "study_metrics.json"),
              "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
