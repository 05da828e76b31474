"""The float32 gradient audit of the conv -> BatchNorm stacks.

A model's gradients in float32 are held against the same gradients in
float64, each parameter's largest error as a share of that tensor's largest
entry (``error_shares``), in settings that change one op at a time
(``audit_setting``):

  * ``"shipped"``: the model as it is (``ops.conv.conv`` chooses the route);
  * ``"cudnn"``: every conv that feeds a training BatchNorm
    (``bn_fed_convs``) through ``F.conv1d`` / ``F.conv2d`` (cuDNN on the
    card, TF32 as the caller set it), as before ``ops/conv.py``;
    ``"product"``: through ``ops.conv.ProductConv``; ``"product32"``: the
    same unfolded product summed in float32 (autograd's backward, TF32 as
    the caller set it);
  * ``"tf32"``: cuDNN's TF32 on (PyTorch's default); ``"no_cudnn"``:
    cuDNN disabled (PyTorch's own convolution);
  * ``"bn64"``: every ``BatchNorm`` computed in float64;
  * ``"<conv name>:<mode>"``: that one conv with its forward and both
    gradients in float64 (``float64``), or only its data gradient
    (``dgrad64``) or only its weight gradient (``wgrad64``), so that a
    setting that brings the error down names the op.

Every setting but ``"shipped"`` and ``"product"`` puts the convs it does
not name on cuDNN's route. ``kinks`` records the inputs of a model file's
ReLUs, or makes them take another run's sides of 0; ``kink_flips`` counts
the elements where two runs differ. ``captured_gradients`` records the
gradients that a training step hands to its all-reduce, before and after
the reduction; ``to_float64`` gives a training state whose steps run in
float64.
"""

import contextlib

import torch
import torch.nn.functional as F

from gantron_tpu_torch.models.classifier import Conv2d
from gantron_tpu_torch.models.modules import BatchNorm, ConvNorm
from gantron_tpu_torch.ops.conv import (ProductConv, _as_4d, _out_shape,
                                        _unfold_args)

CONV_MODES = ("float64", "dgrad64", "wgrad64")


def bn_fed_convs(model):
    """[(name, module)] of ``model``'s convolutions that feed a BatchNorm:
    its ``ConvNorm``s (Tacotron2's encoder and postnet) and the
    classifier's ``Conv2d`` layers."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, (Conv2d, ConvNorm))]


def conv_args(m):
    """(weight, bias, padding, dilation) of a ``bn_fed_convs`` module."""
    if isinstance(m, ConvNorm):
        c = m.conv
        return c.weight, c.bias, c.padding[0], c.dilation[0]
    return m.weight, m.bias, 1, 1


class _SplitPrecisionConv(torch.autograd.Function):
    """The conv's forward in x's dtype, its data gradient computed in
    ``dgrad_dtype`` and its weight gradient in ``wgrad_dtype``, each
    cast back."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding, dilation, dgrad_dtype,
                wgrad_dtype):
        ctx.save_for_backward(x, weight)
        ctx.args = (padding, dilation, dgrad_dtype, wgrad_dtype)
        fn = F.conv1d if weight.dim() == 3 else F.conv2d
        return fn(x, weight, bias, padding=padding, dilation=dilation)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        padding, dilation, dd, wd = ctx.args
        grad = torch.nn.grad
        conv_input, conv_weight = ((grad.conv1d_input, grad.conv1d_weight)
                                   if weight.dim() == 3 else
                                   (grad.conv2d_input, grad.conv2d_weight))
        dx = conv_input(x.shape, weight.to(dd), dy.to(dd), padding=padding,
                        dilation=dilation).to(x.dtype)
        dw = conv_weight(x.to(wd), weight.shape, dy.to(wd), padding=padding,
                         dilation=dilation).to(weight.dtype)
        db = dy.sum(dim=(0,) + tuple(range(2, dy.dim())))
        return dx, dw, db, None, None, None, None


def _conv_forward(m, mode):
    """A forward for ``bn_fed_convs`` module ``m`` in audit ``mode``
    ("cudnn", "product", "product32", or one of ``CONV_MODES``). It reads
    the weights when called: a ``functional_call`` (the bfloat16 step)
    swaps them in."""
    f64 = torch.float64

    def forward(x, train=False):
        weight, bias, padding, dilation = conv_args(m)
        if mode == "float64":
            fn = F.conv1d if weight.dim() == 3 else F.conv2d
            return fn(x.to(f64), weight.to(f64), bias.to(f64),
                      padding=padding, dilation=dilation).to(x.dtype)
        if mode == "cudnn":
            fn = F.conv1d if weight.dim() == 3 else F.conv2d
            return fn(x, weight, bias, padding=padding, dilation=dilation)
        if mode == "product":
            return ProductConv.apply(x, weight, bias, padding, dilation)
        if mode == "product32":  # the same products summed in float32
            kernel, pad, dil = _unfold_args(weight, padding, dilation)
            cols = F.unfold(_as_4d(x), kernel, dil, pad)
            y = torch.matmul(weight.reshape(weight.shape[0], -1), cols)
            return (y + bias[:, None]).reshape(
                y.shape[:2] + _out_shape(x, weight, padding, dilation))
        dd = f64 if mode == "dgrad64" else x.dtype
        wd = f64 if mode == "wgrad64" else x.dtype
        return _SplitPrecisionConv.apply(x, weight, bias, padding, dilation,
                                         dd, wd)

    return forward


def _bn64_forward(bn):
    orig = bn.forward

    def forward(x, train=False):
        return orig(x.to(torch.float64), train).to(x.dtype)

    return forward


def audit_settings(model, modes=CONV_MODES):
    """Every setting of the module docstring for ``model``, in order, each
    conv in each of ``modes``."""
    return (["shipped", "cudnn", "product32", "tf32", "no_cudnn", "bn64"]
            + [f"{n}:{mode}" for n, _ in bn_fed_convs(model)
               for mode in modes])


@contextlib.contextmanager
def audit_setting(model, setting):
    """``model`` in audit ``setting`` (module docstring) within; its
    modules and the cuDNN flags restored on exit."""
    patched, flags = [], contextlib.nullcontext()

    def patch(m, forward):
        m.forward = forward
        patched.append(m)

    if setting != "shipped":
        convs = dict(bn_fed_convs(model))
        one, _, mode = setting.partition(":")
        if mode and one not in convs:
            raise ValueError(f"no conv {one!r} feeds a BatchNorm")
        route = setting if setting in ("product", "product32") else "cudnn"
        for n, m in convs.items():
            patch(m, _conv_forward(m, mode if n == one else route))
        if setting == "bn64":
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    patch(m, _bn64_forward(m))
        elif setting == "tf32":
            flags = torch.backends.cudnn.flags(enabled=True, allow_tf32=True)
        elif setting == "no_cudnn":
            flags = torch.backends.cudnn.flags(enabled=False)
        elif not mode and route == "cudnn" and setting != "cudnn":
            raise ValueError(f"unknown audit setting {setting!r}")
    try:
        with flags:
            yield model
    finally:
        for m in patched:
            del m.forward


class _KinkFunctional:
    """``torch.nn.functional`` with ``relu`` and ``leaky_relu`` that record
    each call's input or take another run's branches."""

    def __init__(self, replay):
        self.inputs, self.replay, self.calls = [], replay, 0

    def __getattr__(self, name):
        return getattr(F, name)

    def _branch(self, x):
        if self.replay is None:
            self.inputs.append(x.detach())
            return x > 0
        self.calls += 1
        return self.replay[self.calls - 1].to(x.device) > 0

    def relu(self, x, inplace=False):
        return torch.where(self._branch(x), x, 0.0)

    def leaky_relu(self, x, negative_slope=0.01, inplace=False):
        return torch.where(self._branch(x), x, negative_slope * x)


@contextlib.contextmanager
def kinks(module, replay=None):
    """Within, the ``F.relu`` and ``F.leaky_relu`` calls of ``module`` (a
    model file, e.g. ``models.classifier``) record each call's input into
    the list yielded, in call order; with ``replay`` (such a list from
    another run) each call takes that run's branch (input > 0) instead, so
    that a float32 run follows float64's piecewise-linear pieces. A
    gradient is discontinuous at a kink: where float32 rounding puts an
    input on the other side of 0 than float64 does, the gradient through
    that element changes by the whole difference of the slopes."""
    fn = _KinkFunctional(replay)
    module.F = fn
    try:
        yield fn.inputs
    finally:
        module.F = F


def kink_flips(inputs, ref, show=0):
    """The number of elements that take the other branch (input > 0) than
    in ``ref``, by call; with ``show``, also the first ``show`` of them by
    call as (this run's input, ``ref``'s input, ``ref``'s standard
    deviation over the call)."""
    flips, shown = [], []
    for x, r in zip(inputs, ref):
        x, r = x.detach().cpu().double(), r.detach().cpu().double()
        where = ((x > 0) != (r > 0)).nonzero(as_tuple=True)
        flips.append(int(where[0].numel()))
        shown.append([(x[i].item(), r[i].item(), r.std().item())
                      for i in zip(*where)][:show])
    return (flips, shown) if show else flips


def error_shares(got, ref):
    """{name: max |got - ref| / max |ref|} over the tensors of ``ref`` (0
    where ``ref`` is all zero and ``got`` equals it)."""
    out = {}
    for n, r in ref.items():
        r = r.detach().cpu().double()
        err = (got[n].detach().cpu().double() - r).abs().max().item()
        top = r.abs().max().item()
        out[n] = err / top if top else (0.0 if err == 0 else float("inf"))
    return out


@contextlib.contextmanager
def captured_gradients():
    """A list that receives, for each call of the training steps'
    all-reduce (``train/step.py``) within, a pair of lists of CPU copies:
    the tensors handed to it, before any reduction, and what it returned
    (the same values without a process group). A G step's first call
    carries its parameter gradients, in ``named_parameters`` order."""
    from gantron_tpu_torch.train import step

    calls, reduce = [], step.all_reduce_mean_

    def record(tensors):
        tensors = list(tensors)
        before = [t.detach().cpu().clone() for t in tensors]
        tensors = reduce(tensors)
        calls.append((before, [t.detach().cpu().clone() for t in tensors]))
        return tensors

    step.all_reduce_mean_ = record
    try:
        yield calls
    finally:
        step.all_reduce_mean_ = reduce


def to_float64(state, g_tx, d_tx):
    """A fresh training state (no step taken) with its models, BatchNorm
    statistics and Adam moments in float64; ``make_train_steps`` of its
    models then takes float64 steps throughout (the precision audit's
    reference). Returns ``state``."""
    state.g_model.double()
    state.d_model.double()
    state.g_opt_state = g_tx.init(list(state.g_model.parameters()))
    state.d_opt_state = d_tx.init(list(state.d_model.parameters()))
    return state
