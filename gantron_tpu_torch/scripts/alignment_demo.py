"""Attention-alignment emergence demo on real wav files (port of
scripts/alignment_demo.py).

Trains a small GANtron on the toy tone-language corpus (each character is
a distinct tone, so the ground-truth alignment is a clean diagonal) through
the whole pipeline: wavs written from a seed, log-mels by the mel kernel
into the cache (once a cold wav), bucketed batches, the G/D loop
(``train.loop.train``), with validation media at each checkpoint. With
matplotlib installed those are PNG plots; without it (as on the card's
machine) the loop says so and writes each validation alignment as
``iter<N>_s<j>_align.npy``, (T_in, T_out), where its PNG would go.

Usage: python -m gantron_tpu_torch.scripts.alignment_demo -o DIR
       [--iterations 400] [--n_utts 64] [--hparams k=v,...] [--device cpu]
"""

import argparse
import os

from gantron_tpu_torch.scripts._study_common import (add_device_argument,
                                                     print_launches)


def demo_hparams(iterations, train_list, val_list, hparams=None):
    """The JAX script's small model and schedule over its corpus lists."""
    from gantron_tpu_torch.config import HParams

    hp = HParams()
    hp.add_params(dict(
        symbols_embedding_dim=64, encoder_embedding_dim=64,
        encoder_n_convolutions=2, attention_rnn_dim=96, decoder_rnn_dim=96,
        prenet_dim=32, attention_dim=32, attention_location_n_filters=8,
        attention_location_kernel_size=15, postnet_embedding_dim=64,
        postnet_n_convolutions=3, noise_size=16, discriminator_dim=64,
        max_decoder_steps=60, use_noise=True, use_labels=False,
        scan_unroll=1, mesh_shape=[1], validation_audio=False,
        batch_size=8, iterations=iterations,
        iters_per_checkpoint=max(iterations // 4, 1),
        disc_warmp_up=40, attn_steps=iterations,  # guide loss all run
        g_learning_rate=2e-3, d_learning_rate=7e-4,
        text_buckets=[12], mel_buckets=[60],
        training_files=[train_list], validation_files=[val_list],
    ))
    if hparams:
        hp.add_params_string(hparams)
    return hp


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-o", "--output", default="/tmp/align_demo")
    parser.add_argument("--iterations", type=int, default=400)
    parser.add_argument("--n_utts", type=int, default=64)
    parser.add_argument("--hparams", type=str, default=None,
                        help="extra k=v,k=v overrides (e.g. "
                             "n_frames_per_step=2 or fp16_run=True)")
    add_device_argument(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from gantron_tpu_torch.data.toy import build_corpus
    from gantron_tpu_torch.train.loop import train
    from gantron_tpu_torch.utils import plotting
    from gantron_tpu_torch.utils.logging import MetricLogger

    corpus_root = os.path.join(args.output, "corpus")
    os.makedirs(corpus_root, exist_ok=True)
    wav_dir, train_list, val_list = build_corpus(
        corpus_root, n_utts=args.n_utts, n_train=args.n_utts - 8,
        min_chars=5, max_chars=9)
    hp = demo_hparams(args.iterations, train_list, val_list, args.hparams)

    out = os.path.join(args.output, "run")
    logger = MetricLogger(out, run_name="align")
    train(out, None, False, hp, wav_dir, logger=logger, device=args.device)
    what = "plots" if plotting.available() else "arrays (_align.npy)"
    print(f"\nDone. Alignment {what} in {out}/media/")
    print_launches()


if __name__ == "__main__":
    main()
