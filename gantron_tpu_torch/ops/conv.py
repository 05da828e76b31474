"""Convolutions that feed a training-mode BatchNorm.

The encoder's and postnet's 1-D convolutions and the emotion classifier's
3x3 ones each feed a BatchNorm that normalizes with the batch's statistics.
Its backward takes the mean out of the gradient it passes up, so the
gradients below it are sums that nearly cancel, and its forward divides by
the channel's spread, which magnifies an error of the conv's output by the
channel's mean over its spread. On the card, cuDNN's float32 algorithms
(an implicit GEMM and an FFT route, its complex GEMM among the kernels)
sum thousands of products in float32 and leave the output a few units in
the last place from the exact one (chip_smoke.py phase 24 (a)'s bare
forward): enough to move the gradients of a full-width G step by 1.5e-5 of
a tensor's largest entry, and to put an input of the ReLU or LeakyReLU
after the BatchNorm on the other side of 0 than the exact value, where the
gradient jumps (phase 21).

``conv`` computes ``F.conv1d`` / ``F.conv2d`` (stride 1, zero padding,
dilation) for a conv whose BatchNorm is in training mode, and chooses the
route by what it is given:

  * a float32 tensor under autograd (a float32 training step) goes
    through ``ProductConv``: the input unfolded (im2col) and one product
    with the weight, the products and their sums in float64 (no TF32) and
    the result rounded once to float32; the backward is two more such
    products and a fold. It does so on the CPU too, so that the card and
    the CPU, which the parity checks hold against each other, compute the
    same function and round it the same way;
  * anything else (the bfloat16 copies of ``fp16_run``, a pass with no
    autograd history) goes to ``F.conv1d`` / ``F.conv2d``, cuDNN on the
    card. So do inference and the rollouts, whose BatchNorms read their
    running statistics: their callers never reach ``conv``.

``ProductConv`` recomputes the unfolded input in its backward rather than
saving it: it holds only what the conv holds.
"""

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable


def _unfold_args(weight, padding, dilation):
    """F.unfold's (kernel, padding, dilation) for a 1-D (O, C, k) or 2-D
    (O, C, kh, kw) weight; a 1-D input is unfolded as (B, C, 1, T)."""
    if weight.dim() == 3:
        return (1, weight.shape[2]), (0, padding), (1, dilation)
    return tuple(weight.shape[2:]), (padding, padding), (dilation, dilation)


def _as_4d(x):
    return x[:, :, None] if x.dim() == 3 else x


def _out_shape(x, weight, padding, dilation):
    """The output's spatial shape: stride 1, so each axis of n grows by
    2 padding and shrinks by dilation (k - 1)."""
    return tuple(n + 2 * padding - dilation * (k - 1)
                 for n, k in zip(x.shape[2:], weight.shape[2:]))


class ProductConv(torch.autograd.Function):
    """``F.conv1d`` / ``F.conv2d`` (stride 1, symmetric zero ``padding``,
    ``dilation``) as explicit products in float64, each result rounded
    once to the input's dtype: y = W (O, C k) @ unfold(x) (B, C k, L);
    dW = dy @ unfold(x)^T over every sample's positions at once; dx =
    fold(W^T @ dy). Once differentiable."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding, dilation):
        f64 = torch.float64
        kernel, pad, dil = _unfold_args(weight, padding, dilation)
        cols = F.unfold(_as_4d(x).to(f64), kernel, dil, pad)
        y = torch.matmul(weight.reshape(weight.shape[0], -1).to(f64), cols)
        if bias is not None:
            y = y + bias[:, None]
        ctx.save_for_backward(x, weight)
        ctx.geometry = (kernel, pad, dil, bias is not None)
        return y.to(x.dtype).reshape(
            y.shape[:2] + _out_shape(x, weight, padding, dilation))

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        f64 = torch.float64
        x, weight = ctx.saved_tensors
        kernel, pad, dil, has_bias = ctx.geometry
        B, O = dy.shape[:2]
        dy = dy.reshape(B, O, -1)
        dy64 = dy.to(f64)
        dx = dw = db = None
        if ctx.needs_input_grad[1]:
            cols = F.unfold(_as_4d(x).to(f64), kernel, dil, pad)
            # One (O, B L) @ (B L, C k) product: every position of every
            # sample in one sum.
            dw = (dy64.transpose(0, 1).reshape(O, -1)
                  @ cols.transpose(1, 2).reshape(-1, cols.shape[1]))
            dw = dw.reshape(weight.shape).to(weight.dtype)
        if ctx.needs_input_grad[0]:
            dcols = torch.matmul(weight.reshape(O, -1).T.to(f64), dy64)
            dx = F.fold(dcols, _as_4d(x).shape[2:], kernel, dil,
                        pad).reshape(x.shape).to(x.dtype)
        if has_bias and ctx.needs_input_grad[2]:
            db = dy64.sum(dim=(0, 2)).to(weight.dtype)
        return dx, dw, db, None, None


def use_product(x) -> bool:
    """Whether ``conv`` takes the product route: a float32 tensor under
    autograd (module docstring)."""
    return x.dtype == torch.float32 and torch.is_grad_enabled()


def conv(x, weight, bias=None, padding=0, dilation=1):
    """``F.conv1d`` (weight (O, C, k)) or ``F.conv2d`` (weight (O, C, kh,
    kw)) of ``x``, stride 1, by the route the module docstring gives. The
    callers are the convs whose BatchNorm normalizes with the batch's
    statistics; on running statistics they call ``F.conv*d`` themselves."""
    if use_product(x):
        return ProductConv.apply(x, weight, bias, padding, dilation)
    fn = F.conv1d if weight.dim() == 3 else F.conv2d
    return fn(x, weight, bias, padding=padding, dilation=dilation)
