"""Unsupervised emotion-separability check of the PyTorch port
(counterpart of the root ``check_kmeans.py``; reference: check_kmeans.py).

    python -m gantron_tpu_torch.cli.check_kmeans --audio_path corpus/ \
        [--n_clusters 5] [--device cpu]

K-means over fixed-length mel prefixes of a corpus laid out as one
subdirectory per emotion, scored by the best cluster->class assignment.
The wavs are featurized with ``MelSpectrogram`` (one mel-kernel launch a
wav on the card, cached as .npy beside it) and k-means runs on the CUDA
card unless ``--device cpu`` is given.
"""

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--audio_path", type=str, required=True,
                        help="path with one subdirectory per emotion "
                             "(each holding .wav or .npy mels)")
    parser.add_argument("--n_clusters", type=int, default=None,
                        help="default: number of emotion directories")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device for the mels and k-means")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns (basic accuracy, best accuracy, class->cluster
    permutation)."""
    args = parse_args(argv)

    from gantron_tpu_torch.audio.mel import MelSpectrogram
    from gantron_tpu_torch.eval.clustering import (check_kmeans_accuracy,
                                                   load_mels_by_emotion_dir)

    mels, class_ids, names = load_mels_by_emotion_dir(
        args.audio_path, mel_fn=MelSpectrogram(device=args.device))
    print(f"Loaded {len(mels)} mels across {len(names)} classes: {names}")
    basic, best, perm = check_kmeans_accuracy(mels, class_ids,
                                              args.n_clusters,
                                              device=args.device)
    print(f"Basic accuracy is {100 * basic:.2f} %")
    print(f"The accuracy of the classifier is {100 * best:.2f} %, "
          f"with classes {perm}")
    return basic, best, perm


if __name__ == "__main__":
    main()
