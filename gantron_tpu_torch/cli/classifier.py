"""Emotion-classifier training CLI of the PyTorch port (counterpart of the
root ``classifier.py``; reference: classifier.py:296-334).

    python -m gantron_tpu_torch.cli.classifier --audio_path /data \
        --use_labels intended -o out/
    python -m gantron_tpu_torch.cli.classifier ... --device cpu

Trains on VESUS (+ CREMA-D + RAVDESS) emotion labels, optionally extended
with GANtron-generated wavs (labels in the file names), on the CUDA card
unless ``--device cpu`` is given. Writes ``classifier_history.json``.
"""

import argparse
import json
import os


def str2bool(v):
    return str(v).lower() in ("yes", "true", "t", "y", "1")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--audio_path", type=str, required=True,
                        help="root containing VESUS/ Crema-D/ RAVDESS/")
    parser.add_argument("--use_labels", type=str, default="one",
                        help="'one' | 'intended' | 'multi'")
    parser.add_argument("--linear_model", type=str, default="true")
    parser.add_argument("--vesus_only", type=str, default="false")
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--n_frames", type=int, default=80)
    parser.add_argument("--precision", type=int, default=32)
    parser.add_argument("--model_size", type=int, default=512)
    parser.add_argument("--mel_offset", type=int, default=20)
    parser.add_argument("--max_noise", type=int, default=3)
    parser.add_argument("--hparams", type=str, default=None)
    parser.add_argument("--extend_path", type=str, default=None,
                        help="extra GANtron-generated wavs to add to train")
    parser.add_argument("-o", "--output_path", type=str, default="output")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from gantron_tpu_torch.config import ClassifierHParams
    from gantron_tpu_torch.eval.classifier import (ClassifierTrainer, MelCrops,
                                                   load_extension, load_files,
                                                   prepare_npy_mels)

    hp = ClassifierHParams()
    hp.add_params(args)
    hp.linear_model = str2bool(args.linear_model)
    if args.hparams:
        hp.add_params(args.hparams)
    vesus_only = str2bool(args.vesus_only)
    if not hp.linear_model and hp.n_frames % 8 != 0:
        raise SystemExit("n_frames must be a multiple of 8 for the conv "
                         "model (three 2x pools)")

    train_fp, train_emo = load_files(hp.training_files, args.audio_path,
                                     hp.use_labels, vesus_only)
    val_fp, val_emo = load_files(hp.validation_files, args.audio_path,
                                 hp.use_labels, vesus_only)
    test_fp, test_emo = load_files(hp.test_files, args.audio_path,
                                   hp.use_labels, vesus_only)
    if args.extend_path:
        load_extension(args.extend_path, hp.use_labels, train_fp, train_emo)

    train_fp, val_fp, test_fp = prepare_npy_mels(
        [train_fp, val_fp, test_fp], hp, device=args.device)

    trainer = ClassifierTrainer(hp, device=args.device)
    history = trainer.fit(
        MelCrops(train_fp, train_emo, hp.mel_offset, hp.max_noise, seed=1),
        MelCrops(val_fp, val_emo, hp.mel_offset, hp.max_noise, seed=2),
        log_fn=lambda r: print(r))
    test = trainer.evaluate(
        MelCrops(test_fp, test_emo, hp.mel_offset, hp.max_noise, seed=3),
        prefix="test_")
    print(f"Test results: {test}")

    os.makedirs(args.output_path, exist_ok=True)
    with open(os.path.join(args.output_path, "classifier_history.json"),
              "w") as f:
        json.dump({"history": history, **test}, f, indent=2)
    return {"history": history, **test}


if __name__ == "__main__":
    main()
