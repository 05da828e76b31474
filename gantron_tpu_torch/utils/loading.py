"""Model loading helpers for inference and eval CLIs (port of
gantron_tpu/utils/loading.py; reference: inference_samples.py:18-25,
train.py:114-125). They read the port's checkpoints
(``train/checkpoint.py``), not the JAX package's Orbax ones."""

import torch

from gantron_tpu_torch.models.discriminator import make_discriminator
from gantron_tpu_torch.models.tacotron2 import Tacotron2
from gantron_tpu_torch.utils.device import resolve_device


def load_checkpoint_tree(checkpoint_path) -> dict:
    """The checkpoint's payload (``train.checkpoint.state_payload``'s keys)
    on the CPU, read with ``weights_only=True``: tensors, dicts and numbers,
    no pickled code."""
    return torch.load(checkpoint_path, map_location="cpu", weights_only=True)


def load_generator(checkpoint_path, hp, device="cuda") -> Tacotron2:
    """The checkpoint's Tacotron2 (weights and BatchNorm running statistics)
    on ``device``, in eval mode."""
    device = resolve_device(device)
    model = Tacotron2(hp, device=device)
    model.load_state_dict(load_checkpoint_tree(checkpoint_path)["g_state"])
    return model.eval()


def load_discriminator(checkpoint_path, hp, device="cuda"):
    """The checkpoint's discriminator of ``hp.discriminator_type`` on
    ``device``, in eval mode."""
    device = resolve_device(device)
    model = make_discriminator(hp, device=device)
    model.load_state_dict(load_checkpoint_tree(checkpoint_path)["d_state"])
    return model.eval()
