"""NN primitives (port of gantron_tpu/models/modules.py).

The port keeps PyTorch's channel-first (B, C, T) layout for convolutions;
matrices that activations multiply from the right keep the JAX package's
(in, out) layout.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from gantron_tpu_torch.parallel.distributed import (all_reduce_sum,
                                                    process_count)
from gantron_tpu_torch.utils.device import draw

_GAINS = {
    "linear": 1.0,
    "sigmoid": 1.0,
    "tanh": 5.0 / 3.0,
    "relu": math.sqrt(2.0),
}


def xavier_uniform(shape, gain_name: str = "linear",
                   generator: torch.Generator = None) -> torch.Tensor:
    """torch-style ``xavier_uniform_`` with a named gain, for a dense
    (in, out) matrix or a torch conv kernel (out, in, k)."""
    gain = _GAINS[gain_name]
    if len(shape) == 2:
        fan_in, fan_out = shape
    else:
        fan_in, fan_out = shape[1] * shape[2], shape[0] * shape[2]
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator = None) -> torch.Tensor:
    """Inverted dropout driven by an explicit generator (on x's device)."""
    keep = draw(torch.rand, x.shape, generator, device=x.device,
                dtype=torch.float32) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), 0.0)


class ConvNorm(nn.Module):
    """1-D conv with "same" padding for odd kernels; (B, C, T) in and out."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, dilation: int = 1, gain="linear",
                 generator: torch.Generator = None):
        super().__init__()
        assert kernel_size % 2 == 1
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              padding=dilation * (kernel_size - 1) // 2,
                              dilation=dilation)
        with torch.no_grad():
            self.conv.weight.copy_(xavier_uniform(
                (out_channels, in_channels, kernel_size), gain, generator))
            self.conv.bias.zero_()

    def forward(self, x):
        return self.conv(x)


# Flax's BatchNorm momentum (gantron_tpu/models/modules.py): the share of
# the old running statistics kept at each training-mode update.
BN_MOMENTUM = 0.9


class BatchNorm(nn.Module):
    """BatchNorm over channel axis 1, (B, C), (B, C, T) or (B, C, H, W), with
    running statistics, eps 1e-5, in Flax's form (momentum ``BN_MOMENTUM`` on
    the running stats).

    ``train=False`` normalizes with the running statistics. ``train=True``
    normalizes with the batch's statistics over every axis but the channel
    axis (every (B, T) position of a sequence, pad positions included),
    E[x] and E[x^2] - E[x]^2 clipped at 0 (the biased variance, which is
    also what goes into ``running_var``, where ``torch.nn.BatchNorm1d``
    would keep the unbiased one), and updates the running statistics in
    place. The sums behind the two statistics run in ``stats_dtype``:
    float64 by default, over the float32 values (their products exact),
    the statistics then rounded to float32. In float32 the subtraction
    cancels most of E[x^2] for a channel whose mean is large beside its
    spread, and Tacotron2's recurrent decoder amplifies that rounding: one
    G and one D step at tests/test_torch_parallel_steps.py's widths, taken
    twice with the batch's rows in two orders, put Adam's first moments
    1.23 times ``assert_states_match``'s tolerance apart (Intel Xeon host),
    and two data-parallel ranks 1.00 times from one process; with float64
    sums, 0.24 and 0.15 times. The emotion classifier keeps float32 sums:
    its inputs are not dominated by their means, and chip_smoke.py phase
    21's lockstep of its card and CPU training, which passes with them,
    stopped at 1.05 of its gradient bound with float64 sums (NVIDIA H100
    80GB HBM3). Everything else is float32, and the output takes x's
    dtype.

    In a process group of more than one process (data parallel,
    parallel/distributed.py) the batch statistics are the global batch's,
    as XLA computes them on a sharded batch: each rank's per-channel sums,
    sums of squares and counts are summed over the group (differentiably),
    so every rank normalizes with the same statistics and keeps the same
    running ones."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 stats_dtype: torch.dtype = torch.float64):
        super().__init__()
        self.eps = eps
        self.stats_dtype = stats_dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, train: bool = False):
        xf = x.float()
        if train:
            dims = (0,) + tuple(range(2, x.dim()))
            xs = xf.to(self.stats_dtype)
            if process_count() > 1:
                C = xf.shape[1]
                count = xs.new_full((1,), xf.numel() // C)
                sums = all_reduce_sum(torch.cat(
                    [xs.sum(dim=dims), (xs * xs).sum(dim=dims), count]))
                mean = sums[:C] / sums[2 * C]
                mean_sq = sums[C:2 * C] / sums[2 * C]
            else:
                mean = xs.mean(dim=dims)
                mean_sq = (xs * xs).mean(dim=dims)
            var = torch.clamp(mean_sq - mean * mean, min=0.0).float()
            mean = mean.float()
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        shape = (-1,) + (1,) * (x.dim() - 2)  # channel axis 1 broadcast
        y = ((xf - mean.view(shape)) * mul.view(shape)
             + self.bias.float().view(shape))
        return y.to(x.dtype)


def lecun_normal(shape, generator: torch.Generator = None) -> torch.Tensor:
    """Flax's default dense/conv kernel init: truncated normal (at +-2
    standard deviations of the underlying normal) with variance 1 / fan_in,
    for a dense (in, out) matrix or a torch conv kernel (out, in, k...)."""
    fan_in = shape[0] if len(shape) == 2 else math.prod(shape[1:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w * std


def disable_dropout(module: nn.Module) -> nn.Module:
    """Turns off every dropout in ``module``: the decoder's prenet dropout
    (which the reference keeps on at inference) and the training-only
    dropouts (encoder, postnet, attention and decoder LSTMs,
    discriminators). Parity tests of deterministic math use this."""
    for m in module.modules():
        for name in ("prenet_dropout", "train_dropout"):
            if hasattr(m, name):
                setattr(m, name, False)
    return module
