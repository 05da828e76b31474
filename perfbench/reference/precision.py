"""Operand rounding for the reference and its lower-precision controls.

``Precision("float32")`` computes every product in float32 with TF32 off.
``"tf32"`` rounds both operands of every product to TF32 (10 mantissa bits,
round to nearest even) and sums in float32, as the tensor cores do with
TF32 on; it is emulated by rounding, so it reads the same on the CPU and on
the card. ``"bfloat16"`` rounds the operands to bfloat16, and ``"fp8"`` to
float8 e4m3 after a per-tensor scale (largest magnitude to 448). The
recurrence matrices that serving stores as integers are quantized apart,
by ``quantize_per_channel`` with 8 or 4 bits.
"""

import torch
import torch.nn.functional as F

_TF32_DROP = 13  # float32 has 23 mantissa bits, TF32 keeps 10


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> nearest TF32 value (ties to even), kept in float32."""
    bits = x.float().contiguous().view(torch.int32)
    half = (1 << (_TF32_DROP - 1)) - 1
    lsb = (bits >> _TF32_DROP) & 1
    rounded = (bits + half + lsb) & ~((1 << _TF32_DROP) - 1)
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x.float())


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with a per-tensor scale, back in float32."""
    x = x.float()
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


_ROUND = {
    "float32": lambda x: x.float(),
    "tf32": round_tf32,
    "bfloat16": lambda x: x.to(torch.bfloat16).float(),
    "fp8": round_fp8,
}


class _RoundedMM(torch.autograd.Function):
    """a @ b with both operands rounded, forward and backward alike."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return torch.matmul(rnd(a), rnd(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        rnd = ctx.rnd
        ga = torch.matmul(rnd(g), rnd(b).transpose(-1, -2))
        gb = torch.matmul(rnd(a).transpose(-1, -2), rnd(g))
        # Undo broadcasting over leading dimensions.
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb, None


class Precision:
    """Where the reference's products and convolutions round their
    operands. ``name``: "float32", "tf32", "bfloat16" or "fp8"."""

    def __init__(self, name: str = "float32"):
        if name not in _ROUND:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.round = _ROUND[name]

    def mm(self, a, b):
        if self.name == "float32":
            return torch.matmul(a, b)
        return _RoundedMM.apply(a, b, self.round)

    def _st(self, x):
        """Rounded in the forward, straight through in the backward."""
        if self.name == "float32":
            return x
        return x + (self.round(x) - x).detach()

    def conv1d(self, x, w, b=None, padding=0, dilation=1):
        return F.conv1d(self._st(x), self._st(w), b, padding=padding,
                        dilation=dilation)

    def conv_transpose1d(self, x, w, b=None, stride=1):
        return F.conv_transpose1d(self._st(x), self._st(w), b, stride=stride)


def quantize_per_channel(w: torch.Tensor, bits: int) -> torch.Tensor:
    """(I, O) float -> the dequantized per-output-channel symmetric integer
    matrix: scale = max |w| of the column / (2^(bits-1) - 1), values
    rounded to nearest even and clipped to +-(2^(bits-1) - 1)."""
    w = w.float()
    top = float(2 ** (bits - 1) - 1)
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[None, :]), -top, top)
    return q * scale[None, :]


def set_tf32(enabled: bool) -> None:
    """TF32 on or off for PyTorch's own float32 matmuls and convolutions
    (cuBLAS and cuDNN) in this process."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
