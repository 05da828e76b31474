"""Shared plumbing of the study scripts (port of scripts/_study_common.py):
the ≈ 96-dim study model's configuration, the metric-log readout, and what
every study does around its own scoring: the ``--device`` argument,
assembling its ``HParams``, training an arm or rereading its checkpoint,
and naming the device in its JSON."""

import json
import os
import tempfile
import time

STUDY_TEXT = "aeioumnst"  # the campaigns' shared probe text

# The studies' corpus and model: use_noise with a 32-dim style, no labels.
NOISE_STUDY = dict(use_noise=True, noise_size=32, use_labels=False)


def small_model_params(iterations):
    """The ~96-dim study model: big enough to speak the toy tone language,
    small enough to train in minutes on one card. ``scan_unroll`` is kept
    for the JAX package's sake (the port accepts and ignores it) and
    ``mesh_shape`` is one process."""
    return dict(
        symbols_embedding_dim=96, encoder_embedding_dim=96,
        encoder_n_convolutions=2, attention_rnn_dim=128, decoder_rnn_dim=128,
        prenet_dim=48, attention_dim=48, attention_location_n_filters=8,
        attention_location_kernel_size=15, postnet_embedding_dim=96,
        postnet_n_convolutions=3, discriminator_dim=96,
        max_decoder_steps=64,
        scan_unroll=2, mesh_shape=[1], validation_audio=False,
        batch_size=16, iterations=iterations,
        iters_per_checkpoint=max(iterations // 5, 1),
        disc_warmp_up=100, attn_steps=iterations // 2,
        g_learning_rate=1e-3, d_learning_rate=7e-4,
        text_buckets=[12], mel_buckets=[60],
    )


def final_validation(metrics_path):
    """Last logged validation losses from a MetricLogger JSONL file."""
    final_val = {}
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            for line in f:
                rec = json.loads(line)
                for k in ("Validation mel loss", "Validation gate loss"):
                    if k in rec:
                        final_val[k] = rec[k]
    return final_val


def default_root(name):
    """A study's default output root: the JAX script's ``/tmp/<name>`` with
    ``torch_`` in front, under the temporary directory ($TMPDIR when set),
    so runs of the two packages never share a directory."""
    return os.path.join(tempfile.gettempdir(), f"torch_{name}")


def add_device_argument(parser):
    parser.add_argument("--device", default="cuda",
                        help="torch device: the CUDA card unless 'cpu'")


def study_hparams(iterations, fields, variant, hparams=None):
    """The study's ``HParams``: ``small_model_params``, then the study's own
    ``fields`` (corpus, seed, conditioning), the variant's overrides and the
    ``--hparams`` string, each over the last."""
    from gantron_tpu_torch.config import HParams

    hp = HParams()
    hp.add_params(small_model_params(iterations))
    hp.add_params(fields)
    hp.add_params(variant)
    if hparams:
        hp.add_params_string(hparams)
    return hp


def arm_dir(root, variant, seed):
    """``<root>/<variant>`` for seed 0, ``<root>/<variant>_s<seed>`` else."""
    return os.path.join(root, variant + (f"_s{seed}" if seed else ""))


def corpus_dir(root, seed):
    return os.path.join(root, f"corpus{seed}" if seed else "corpus")


def checkpoint_iteration(path):
    from gantron_tpu_torch.train.checkpoint import CheckpointManager

    return CheckpointManager.parse_name(path)[0]


def train_arm(out, run_name, hp, wav_dir, analyze_only, device):
    """Trains the arm into ``out`` (``train.loop.train``, which resumes from
    a checkpoint already there), or with ``analyze_only`` rereads it.
    Returns (iteration, train seconds or None, final validation losses,
    the newest checkpoint's path); the iteration of an ``analyze_only`` run
    is the checkpoint's."""
    from gantron_tpu_torch.train.checkpoint import CheckpointManager
    from gantron_tpu_torch.train.loop import train
    from gantron_tpu_torch.utils.logging import MetricLogger

    iteration = train_seconds = None
    if not analyze_only:
        logger = MetricLogger(out, run_name=run_name)
        t0 = time.time()
        _, iteration = train(out, None, False, hp, wav_dir, logger=logger,
                             device=device)
        train_seconds = round(time.time() - t0, 1)
    final_val = final_validation(
        os.path.join(out, f"{run_name}.metrics.jsonl"))
    ckpt_path = CheckpointManager(out).latest()
    if ckpt_path is None:
        raise FileNotFoundError(f"no checkpoint in {out}")
    if iteration is None:
        iteration = checkpoint_iteration(ckpt_path)
    return iteration, train_seconds, final_val, ckpt_path


def study_sequence():
    """(1, T) int64 ids of ``STUDY_TEXT`` (basic cleaners)."""
    import numpy as np

    from gantron_tpu_torch.text import text_to_sequence

    return np.asarray(text_to_sequence(STUDY_TEXT, ["basic_cleaners"]),
                      np.int64)[None]


def device_label(device):
    """The device for a result's ``device`` field: ``cpu``, or the CUDA
    device and the card's name."""
    import torch

    from gantron_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        return f"cuda:{index} {torch.cuda.get_device_name(index)}"
    return str(device)


def print_launches():
    """One JSON line on stdout, ``{"kernel_launches": {"mel": N, "qmm":
    N}}``: the hand-written kernels' launches in this process (a study
    run's progress.log holds it, after the study's result)."""
    from gantron_tpu_torch.ops.mel import log_mel
    from gantron_tpu_torch.ops.quant import qmm

    print(json.dumps({"kernel_launches": {"mel": log_mel.launches,
                                          "qmm": qmm.launches}}), flush=True)
