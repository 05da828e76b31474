"""K-means / t-SNE cluster analysis CLI of the PyTorch port (counterpart of
the root ``clustering.py``; reference: clustering.py:53-127).

    python -m gantron_tpu_torch.cli.clustering --path mels/ \
        --check_clusterizations --classes_items 10
    python -m gantron_tpu_torch.cli.clustering --path wavs/ --audio \
        --clusters 6 [--device cpu]

Loads .npy mels (or featurizes .wav files with ``MelSpectrogram`` on the
device, one mel-kernel launch a wav on the card), then scores the
clustering against the 'g-i' file-name groups or writes the t-SNE plot
(which needs sklearn and matplotlib) and, with ``-w``, the centroids
vocoded by WaveGlow. K-means runs on the CUDA card unless ``--device cpu``
is given.
"""

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", type=str, required=True,
                        help="folder of .npy mels (or .wav with --audio)")
    parser.add_argument("--check_clusterizations", action="store_true",
                        help="score cluster/label agreement (needs 'g-i' "
                             "named files)")
    parser.add_argument("--classes_items", type=int, default=20)
    parser.add_argument("--save_path", type=str)
    parser.add_argument("--clusters", type=int, default=6)
    parser.add_argument("--n_mel_channels", type=int, default=80)
    parser.add_argument("--audio", action="store_true",
                        help="extract mels from wav files")
    parser.add_argument("-w", "--waveglow", type=str,
                        help="vocode cluster centroids to wav")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device for the mels and k-means")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns (accuracy, classes, k-means result) with
    ``--check_clusterizations``, else (labels, centers, embedding)."""
    args = parse_args(argv)

    import numpy as np

    from gantron_tpu_torch.audio.mel import MelSpectrogram
    from gantron_tpu_torch.eval.clustering import (check_clusterization,
                                                   load_mels, run_clustering,
                                                   save_tsne_plot)

    mel_fn = (MelSpectrogram(n_mel_channels=args.n_mel_channels,
                             device=args.device) if args.audio else None)
    mels, max_val, classes = load_mels(args.path, args.n_mel_channels,
                                       from_audio=args.audio, mel_fn=mel_fn)
    print(f"Loaded {len(mels)} mel spectrograms")

    if args.check_clusterizations:
        result = check_clusterization(mels, classes,
                                      classes_items=args.classes_items,
                                      device=args.device)
        print(f"The accuracy of the classifier is {100 * result[0]:.2f} %, "
              f"with classes {result[1]}")
        return result

    save_path = args.save_path or args.path
    os.makedirs(save_path, exist_ok=True)
    labels, centers, embedded = run_clustering(mels, args.clusters,
                                               device=args.device)
    print("K-means finished")

    if args.waveglow:
        import torch

        from gantron_tpu_torch.data.wav import write_wav
        from gantron_tpu_torch.models.waveglow import load_waveglow

        waveglow = load_waveglow(args.waveglow, device=args.device)
        for i, centroid in enumerate(centers):
            mel = centroid.reshape(args.n_mel_channels, -1) * max_val
            audio = waveglow.infer(torch.as_tensor(mel[None], dtype=torch
                                                   .float32), 0.666)
            write_wav(os.path.join(
                save_path, f"centroid_{i + 1}-of-{args.clusters}.wav"),
                np.asarray(audio[0].cpu()), 22050)
        print("Centroid wavs written")

    if embedded is not None:
        save_tsne_plot(embedded, labels,
                       os.path.join(save_path, "tsne.jpg"), args.clusters)
        print("t-SNE plot saved")
    return labels, centers, embedded


if __name__ == "__main__":
    main()
