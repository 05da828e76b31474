"""GANtron training CLI of the PyTorch port, flag-compatible with the root
``train.py`` (reference: train.py:469-527).

    python -m gantron_tpu_torch.cli.train --wavs_path /data/LJSpeech/wavs/ \
        --hparams use_labels=False,use_noise=True
    python -m gantron_tpu_torch.cli.train --wavs_path synthetic \
        --hparams iterations=50,batch_size=8 --device cpu

Trains on the CUDA card unless ``--device cpu`` is given. A rerun with the
same output directory resumes from its newest checkpoint.

Data parallel, one process a card, ``mesh_shape`` of N devices (or none:
the group's size), the global ``batch_size`` split over the ranks:

    torchrun --nproc_per_node=N -m gantron_tpu_torch.cli.train \
        --wavs_path ... --hparams mesh_shape=[N],batch_size=64 -o DIR

or, as the reference's multiproc.py launches it, one command a rank:

    python -m gantron_tpu_torch.cli.train --n_gpus N --rank R \
        --group_name G --hparams dist_url=tcp://HOST:PORT,... ...

Rank 0 serves the rendezvous at ``dist_url`` and namespaces its keys under
``--group_name``. ``dist_backend`` is NCCL unless set: use gloo on the CPU,
and for two ranks that share one card (NCCL refuses two ranks on one
device). Only rank 0 writes checkpoints, metrics and media.
"""

import argparse
import os


def build_run_name(hp) -> str:
    """(reference train.py:496-501)"""
    return (f"{'vesus' if hp.vesus_path is not None else ''}LJ-"
            f"{'encIn-' if hp.encoder_inputs else ''}"
            f"{hp.noise_size}n-"
            f"{'intended' if hp.use_intended_labels and hp.use_labels else ''}"
            f"{'labels' if hp.use_labels and hp.vesus_path else 'NOlabels'}"
            f"-{'cD' if hp.discriminator_type != 'linear' else 'lD'}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-o", "--output_directory", type=str, required=False,
                        help="directory to save checkpoints")
    parser.add_argument("-c", "--checkpoint_path", type=str, default=None,
                        help="checkpoint path to resume from")
    parser.add_argument("--waveglow_path", type=str, default=None,
                        help="WaveGlow weights for validation audio")
    parser.add_argument("--vesus_path", type=str, default=None,
                        help="VESUS dataset path")
    parser.add_argument("--warm_start", action="store_true",
                        help="load generator weights only, ignore listed "
                             "layers")
    parser.add_argument("--n_gpus", type=int, default=1,
                        help="processes of the group when launched one "
                             "command a rank (rendezvous at dist_url)")
    parser.add_argument("--rank", type=int, default=0,
                        help="this process's rank, with --n_gpus > 1")
    parser.add_argument("--group_name", type=str, default="group_name",
                        help="prefix of the group's rendezvous keys, with "
                             "--n_gpus > 1")
    parser.add_argument("--hparams", type=str, required=False,
                        help="comma separated name=value pairs")
    parser.add_argument("--wavs_path", type=str, required=True,
                        help="path to the wav files, or 'synthetic'")
    parser.add_argument("--resume", type=str, default="",
                        help="run id to resume (logging only)")
    parser.add_argument("--notes", type=str, default="", help="run notes")
    parser.add_argument("--real", type=int, default=1,
                        help="value of 'real' label for the Wasserstein loss")
    parser.add_argument("--attn_steps", type=int, required=False,
                        help="use attention-guide loss for the first N steps")
    parser.add_argument("--use_wandb", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on ('cuda': the rank's "
                             "card in a group)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from gantron_tpu_torch.config import HParams
    from gantron_tpu_torch.parallel.distributed import (initialize_multihost,
                                                        is_chief)
    from gantron_tpu_torch.train.loop import train
    from gantron_tpu_torch.utils.device import resolve_device
    from gantron_tpu_torch.utils.logging import MetricLogger

    hp = HParams.create(args.hparams)
    hp.add_params(args)
    if not hp.use_noise:
        hp.noise_size = 0
    if hp.d_freq == 0:
        hp.disc_warmp_up = 0

    # The process group before the device: "cuda" names the rank's card.
    if args.n_gpus > 1:
        initialize_multihost(hp.dist_url, args.n_gpus, args.rank,
                             backend=hp.dist_backend,
                             group_name=args.group_name)
    else:
        initialize_multihost(backend=hp.dist_backend)
    device = resolve_device(args.device)
    if device.index is not None and device.type == "cuda":
        torch.cuda.set_device(device)  # NCCL's collectives run there

    name = build_run_name(hp)
    output_directory = args.output_directory or os.path.join("output", name)
    logger = None
    if is_chief():
        print(f"Run {name} started")
        logger = MetricLogger(output_directory, run_name=name,
                              use_wandb=args.use_wandb, config=hp.as_dict())
    try:
        return train(output_directory, args.checkpoint_path, args.warm_start,
                     hp, args.wavs_path, logger=logger, real=float(args.real),
                     waveglow_path=args.waveglow_path, device=device)
    finally:
        if logger is not None:
            logger.close()


if __name__ == "__main__":
    from gantron_tpu_torch.parallel.distributed import shutdown

    try:
        main()
    finally:
        shutdown()
