"""Emotion classifier (port of gantron_tpu/models/classifier.py; reference:
classifier.py:21-135).

Two variants over fixed-size mel crops (n_mel x n_frames):
  * linear: 3 x (Dense + BatchNorm + Dropout 0.5 + LeakyReLU 0.1) + head;
  * conv: 4 x (3x3 SAME conv + BatchNorm + Dropout + LeakyReLU [+ 2x2/2
    average pool after the first three]) + flatten + Dense head.

The conv variant runs NCHW with H = n_mel and W = n_frames, as the JAX
package's NHWC ``crops[..., None]`` does; it flattens in the JAX package's
(H, W, C) order before the head, so the head's rows mean the same on both
sides. Training takes a random ``n_frames`` crop per sample starting at or
after ``mel_offset``; inference slides a window over any length. Random
draws come from an explicit ``torch.Generator``.
"""

import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gantron_tpu_torch.models.discriminator import Dense
from gantron_tpu_torch.models.modules import BatchNorm, dropout, lecun_normal
from gantron_tpu_torch.utils.device import resolve_device


# The hidden layers' biases, each followed by a training-mode BatchNorm that
# removes it: their exact gradient is 0, so any two implementations hold
# float32 rounding noise there, which Adam scales up to the learning rate.
BN_FED_BIAS = re.compile(r"^layers\.\d+\.(b|bias)$")


class Conv2d(nn.Module):
    """3x3 SAME conv with lecun-normal init and a zero bias (flax
    ``nn.Conv``'s defaults), NCHW."""

    def __init__(self, in_ch: int, out_ch: int,
                 generator: torch.Generator = None):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal((out_ch, in_ch, 3, 3),
                                                generator))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, padding=1)


class Classifier(nn.Module):
    """``forward(crops, train)``: (B, n_mel, n_frames) normalized mel crops ->
    logits (B, n_emotions). ``train=True`` normalizes with the batch's
    statistics (and updates the running ones) and applies dropout from
    ``generator`` while ``train_dropout`` is on."""

    def __init__(self, hp, generator: torch.Generator = None):
        super().__init__()
        self.hp = hp
        self.linear = bool(hp.linear_model)
        self.train_dropout = True
        n_mel, n_frames = hp.n_mel_channels, hp.n_frames
        if self.linear:
            widths = [n_mel * n_frames] + [hp.model_size] * 3
            self.layers = nn.ModuleList(
                Dense(widths[i], widths[i + 1], generator) for i in range(3))
            head_in = hp.model_size
        else:
            widths = [1] + [hp.model_size] * 3 + [hp.n_emotions]
            self.layers = nn.ModuleList(
                Conv2d(widths[i], widths[i + 1], generator) for i in range(4))
            head_in = (n_mel // 8) * (n_frames // 8) * hp.n_emotions
        self.bns = nn.ModuleList(BatchNorm(w, stats_dtype=torch.float32)
                                 for w in widths[1:])
        self.head = Dense(head_in, hp.n_emotions, generator)

    @property
    def device(self) -> torch.device:
        return self.head.w.device

    def forward(self, crops, train: bool = True,
                generator: torch.Generator = None):
        x = crops.to(self.head.w.dtype)
        x = x.reshape(x.shape[0], -1) if self.linear else x[:, None]
        for i, (layer, bn) in enumerate(zip(self.layers, self.bns)):
            x = bn(layer(x), train)
            if train and self.train_dropout:
                x = dropout(x, 0.5, generator)
            x = F.leaky_relu(x, 0.1)
            if not self.linear and i < 3:
                x = F.avg_pool2d(x, 2, 2)
        if not self.linear:
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (H, W, C)
        return self.head(x)

    @torch.no_grad()
    def predict(self, crops) -> torch.Tensor:
        """Eval-mode class probabilities for fixed-size crops."""
        return torch.softmax(self(crops, train=False), dim=-1)


def make_classifier(hp, device="cuda", seed: int = 0) -> Classifier:
    """A ``Classifier`` with weights drawn from ``seed`` on the CPU, moved to
    ``device``."""
    device = resolve_device(device)
    return Classifier(hp, torch.Generator().manual_seed(seed)).to(device)


def crop_range(length, n_frames, mel_offset):
    """(lo, span) of a crop start for a mel of ``length`` frames: the start
    is ``lo + draw % span`` (JAX's arithmetic, reference
    classifier.py:46-53), in [mel_offset, length - n_frames) when possible.
    Array-likes broadcast."""
    length = np.asarray(length, np.int64)
    hi = np.maximum(length - n_frames, 1)
    lo = np.where(length - n_frames > mel_offset, mel_offset, 0)
    return lo, np.maximum(hi - lo, 1)


def random_crop_start(length, n_frames, mel_offset,
                      generator: torch.Generator = None):
    """A random crop start for each of ``length`` (an int or a (B,) array):
    a draw in [0, 2^30) from ``generator`` (on the CPU), modulo the span."""
    lo, span = crop_range(length, n_frames, mel_offset)
    draws = torch.randint(0, 1 << 30, np.shape(lo), generator=generator)
    return draws.numpy() % span + lo


def crop_batch(mels, lengths, n_frames, mel_offset,
               generator: torch.Generator = None, starts=None):
    """(B, n_mel, T) -> (B, n_mel, n_frames) crops, one per sample, each
    starting at its draw (``random_crop_start``) or at ``starts`` when given,
    clipped to [0, T - n_frames]."""
    B, M, T = mels.shape
    if starts is None:
        starts = random_crop_start(np.asarray(lengths), n_frames, mel_offset,
                                   generator)
    starts = torch.as_tensor(np.clip(np.asarray(starts), 0, T - n_frames),
                             device=mels.device)
    idx = starts[:, None] + torch.arange(n_frames, device=mels.device)
    return torch.gather(mels, 2, idx[:, None, :].expand(B, M, n_frames))


def sliding_window_probs(predict, mel, n_frames):
    """Class probabilities averaged over the non-overlapping windows of
    ``mel`` (B, n_mel, T), plus one tail window ending at T, or the mel
    zero-padded to one window when T < n_frames (reference
    classifier.py:112-135). ``predict``: crops -> probabilities."""
    B, M, T = mel.shape
    n_full = T // n_frames
    crops = [mel[:, :, i * n_frames:(i + 1) * n_frames]
             for i in range(n_full)]
    if T % n_frames != 0 or n_full == 0:
        crops.append(mel[:, :, T - n_frames:] if T >= n_frames
                     else F.pad(mel, (0, n_frames - T)))
    probs = predict(torch.cat(crops, dim=0))  # (B * n_windows, classes)
    return probs.reshape(len(crops), B, -1).mean(dim=0)
