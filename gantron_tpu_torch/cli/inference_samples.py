"""Sample generation CLI of the PyTorch port (counterpart of the root
``inference_samples.py``; reference: inference_samples.py:146-177).

    python -m gantron_tpu_torch.cli.inference_samples \
        -c out/iter=...ckpt -o samples/ --samples 8 --generate_audio

Generates mels (and optionally wavs) from a checkpoint written by the port's
training loop, with forced or random styles/emotions, on the CUDA card
unless ``--device cpu`` is given.
"""

import argparse
import os

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--checkpoint_path", type=str, required=True,
                        help="GANtron checkpoint path")
    parser.add_argument("--generate_audio", action="store_true",
                        help="also vocode wav files")
    parser.add_argument("--force", action="store_true",
                        help="generate with forced styles/emotions")
    parser.add_argument("-w", "--waveglow_path", type=str, required=False,
                        help="WaveGlow checkpoint (Griffin-Lim if absent)")
    parser.add_argument("-o", "--output_path", type=str, required=True)
    parser.add_argument("--samples", type=int, default=200)
    parser.add_argument("--hparams", type=str, required=False)
    parser.add_argument("--speaker", default=0, type=int)
    parser.add_argument("--text", type=str,
                        default="This voice was generated by a machine")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to sample on")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.eval.sampling import (force_style_emotions,
                                                 random_style)
    from gantron_tpu_torch.text import text_to_sequence
    from gantron_tpu_torch.utils.device import generator
    from gantron_tpu_torch.utils.loading import load_generator

    os.makedirs(args.output_path, exist_ok=True)
    hp = HParams.create(args.hparams)
    hp.add_params(args)
    if not hp.use_noise:
        hp.noise_size = 0

    model = load_generator(args.checkpoint_path, hp, args.device)
    sequence = np.asarray(text_to_sequence(args.text, ["english_cleaners"]),
                          np.int64)[None]
    speaker = args.speaker if args.hparams is not None else None
    gen = generator(model.device, args.seed)

    if args.force:
        reached = force_style_emotions(
            model, sequence, args.output_path, speaker=speaker,
            force_emotions=model.use_labels, force_style=hp.use_noise,
            style_shape=[sequence.shape[1], hp.noise_size],
            max_decoder_steps=hp.max_decoder_steps, generator=gen)
        print(f"max_decoder_steps reached for {reached} samples")
        return
    mels, lengths = random_style(model, sequence, args.samples,
                                 speaker=speaker, generator=gen,
                                 max_decoder_steps=hp.max_decoder_steps)
    for i in range(args.samples):
        np.save(os.path.join(args.output_path, f"{i}.npy"),
                mels[i, :, : int(lengths[i])])
    if args.generate_audio:
        waveglow = None
        if args.waveglow_path:
            from gantron_tpu_torch.models.waveglow import load_waveglow

            waveglow = load_waveglow(args.waveglow_path, device=args.device)
        from gantron_tpu_torch.eval.study import compute_wavs

        compute_wavs(args.output_path, args.output_path, hp,
                     waveglow=waveglow, generator=torch.Generator(
                         device=model.device).manual_seed(args.seed),
                     device=args.device)


if __name__ == "__main__":
    main()
