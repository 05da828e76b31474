"""NN primitives (port of gantron_tpu/models/modules.py).

The port keeps PyTorch's channel-first (B, C, T) layout for convolutions;
matrices that activations multiply from the right keep the JAX package's
(in, out) layout.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

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
    keep = torch.rand(x.shape, generator=generator, device=x.device,
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


class BatchNorm(nn.Module):
    """Eval-form BatchNorm over (B, C, T) with running statistics, eps 1e-5."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean[:, None]) * mul[:, None] \
            + self.bias[:, None]
