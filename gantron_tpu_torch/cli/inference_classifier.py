"""Classifier inference CLI of the PyTorch port (counterpart of the root
``inference_classifier.py``; reference: inference_classifier.py:82-108).

    python -m gantron_tpu_torch.cli.inference_classifier -c clf.pt \
        --path a.wav
    python -m gantron_tpu_torch.cli.inference_classifier -c clf.pt \
        --path savee/ --inference_folder --dataset SAVEE [--device cpu]

Predicts emotions for a wav file or a folder (SAVEE / CREMA-D labels
decoded from the file names for the folder's accuracy) with a classifier
saved by ``ClassifierTrainer.save``, on the CUDA card unless ``--device
cpu`` is given.
"""

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--classifier_path", type=str, required=True,
                        help="classifier file saved by "
                             "ClassifierTrainer.save")
    parser.add_argument("--path", type=str, required=True)
    parser.add_argument("--hparams", type=str)
    parser.add_argument("--sr", type=int, default=22050)
    parser.add_argument("--inference_folder", action="store_true")
    parser.add_argument("--dataset", type=str,
                        help="SAVEE or CREMA-D (for folder accuracy)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run the classifier on")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns the folder's accuracy in percent, or the wav's emotion."""
    args = parse_args(argv)

    from gantron_tpu_torch.eval.classifier import ClassifierTrainer
    from gantron_tpu_torch.eval.inference_classifier import (
        inference_folder, inference_from_path)

    trainer = ClassifierTrainer.load(args.classifier_path,
                                     device=args.device)
    hp = trainer.hp
    if args.hparams:
        hp.add_params(args.hparams)

    if args.inference_folder:
        return inference_folder(trainer.model, args.path, args.dataset, hp,
                                args.sr)
    _, emotion = inference_from_path(trainer.model, args.path, hp, args.sr)
    print(f"Inferred emotion for {args.path} is: {emotion}")
    return emotion


if __name__ == "__main__":
    main()
