"""Training state for the GAN and its optimizer (port of
gantron_tpu/train/state.py), and for Flowtron (``FlowtronTrainState``).

The optimizer is torch.optim.Adam's semantics written out as the JAX
package's optax chain: clip the gradients by their global norm (scaled by
``max_norm / norm`` only when ``norm >= max_norm``, with no epsilon, as
``optax.clip_by_global_norm``), add the L2 term ``weight_decay * param``, then
bias-corrected Adam moments (``B1`` 0.9, ``B2`` 0.999, ``EPS`` 1e-8). The
learning rate is an argument of each update, not a state of the optimizer.
"""

import math
import re
from dataclasses import dataclass
from typing import Callable, List, NamedTuple

import numpy as np
import torch
from torch import nn

from gantron_tpu_torch.models.discriminator import make_discriminator
from gantron_tpu_torch.models.tacotron2 import Tacotron2
from gantron_tpu_torch.parallel.distributed import rank_seed
from gantron_tpu_torch.utils.device import generator, resolve_device

# Independent random streams of a training run, all derived from its seed.
_DROPOUT, _NOISE = range(2)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(
        torch.sum(t.to(torch.promote_types(t.dtype, torch.float32)) ** 2)
        for t in tensors))


class AdamState(NamedTuple):
    count: int                # updates taken
    mu: List[torch.Tensor]    # first moments, one per parameter
    nu: List[torch.Tensor]    # second moments


# optax.scale_by_adam's constants, which the JAX package's chain keeps.
B1, B2, EPS = 0.9, 0.999, 1e-8


class Optimizer(NamedTuple):
    """clip -> + weight_decay * param -> Adam -> -lr (``make_optimizer``).
    ``init(params)`` gives the zero moments; ``update(grads, state, params,
    lr)`` updates ``params`` in place and returns the new moments. ``lr``
    may be a float or a 0-dim tensor."""

    init: Callable[[List[torch.Tensor]], AdamState]
    update: Callable[..., AdamState]


def make_optimizer(clip_norm: float, weight_decay: float) -> Optimizer:
    """The optimizer of one network: no clip when ``clip_norm`` is 0."""
    def init(params) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(grads, state: AdamState, params, lr) -> AdamState:
        grads = list(grads)
        if clip_norm and clip_norm > 0:
            norm = global_norm(grads)
            keep = norm < clip_norm
            grads = [torch.where(keep, g, g / norm * clip_norm)
                     for g in grads]
        if weight_decay:
            grads = [g + weight_decay * p for g, p in zip(grads, params)]
        count = state.count + 1
        # Bias corrections in float32, as optax computes them.
        bc1 = float(1 - np.float32(B1) ** np.float32(count))
        bc2 = float(1 - np.float32(B2) ** np.float32(count))
        mu, nu = [], []
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            m = (1 - B1) * g + B1 * m
            v = (1 - B2) * (g * g) + B2 * v
            p.add_(-lr * ((m / bc1) / (torch.sqrt(v / bc2) + EPS)))
            mu.append(m)
            nu.append(v)
        return AdamState(count, mu, nu)

    return Optimizer(init, update)


@dataclass
class GANTrainState:
    """Everything a training step reads and updates: both networks (their
    parameters, and the generator's BatchNorm running statistics as
    buffers), both Adam states, the step count, and the generators that
    draw the step's dropout masks and noise. Steps update it in place."""

    step: int
    g_model: Tacotron2
    d_model: nn.Module
    g_opt_state: AdamState
    d_opt_state: AdamState
    dropout_generator: torch.Generator
    noise_generator: torch.Generator

    def seed_generators(self, seed: int) -> None:
        """Seeds the dropout and noise generators from ``seed`` (and the
        rank, in a group of more than one process)."""
        self.dropout_generator.manual_seed(rank_seed(2 * seed + _DROPOUT))
        self.noise_generator.manual_seed(rank_seed(2 * seed + _NOISE))


def wrap_models(hp, g_model, d_model, seed: int, g_opt_state=None,
                d_opt_state=None, step: int = 0):
    """A state around these models (fresh Adam states unless given), with
    its dropout and noise generators seeded from ``seed`` (and the rank, in
    a group of more than one process) on the models' device. Returns
    (state, g_model, d_model, g_tx, d_tx)."""
    device = g_model.device
    g_tx = make_optimizer(hp.grad_clip_thresh, hp.weight_decay)
    # D is clipped at clipping_value unless the gradient penalty replaces it.
    d_clip = hp.clipping_value if hp.gradient_penalty_lambda <= 0 else 0.0
    d_tx = make_optimizer(d_clip, hp.weight_decay)
    state = GANTrainState(
        step=step, g_model=g_model.train(), d_model=d_model.train(),
        g_opt_state=g_opt_state or g_tx.init(list(g_model.parameters())),
        d_opt_state=d_opt_state or d_tx.init(list(d_model.parameters())),
        dropout_generator=torch.Generator(device=device),
        noise_generator=torch.Generator(device=device))
    state.seed_generators(seed)
    return state, g_model, d_model, g_tx, d_tx


@dataclass
class FlowtronTrainState:
    """What Flowtron's training step reads and updates (in place): the
    model (parameters, and the encoder's BatchNorm running statistics as
    buffers), its Adam state, the step count and the dropout generator."""

    step: int
    model: nn.Module
    opt_state: AdamState
    dropout_generator: torch.Generator


def wrap_flowtron(cfg, model, seed: int):
    """A fresh state around a ``models.flowtron.Flowtron``, its dropout
    generator seeded from ``seed`` on the model's device, and its optimizer:
    ``make_optimizer(cfg.grad_clip_val, cfg.weight_decay)``. Returns
    (state, optimizer)."""
    tx = make_optimizer(cfg.grad_clip_val, cfg.weight_decay)
    state = FlowtronTrainState(
        step=0, model=model.train(), opt_state=tx.init(list(
            model.parameters())),
        dropout_generator=torch.Generator(device=model.device).manual_seed(
            seed))
    return state, tx


def create_train_state(hp, seed: int, sample_batch, device="cuda"):
    """Models, optimizers and state from ``seed`` on ``device`` (weights drawn
    on the CPU, so every device starts from the same ones). ``sample_batch``
    is a ``Batch`` of the shapes training will see; its mel length must be a
    multiple of n_frames_per_step. Returns (state, g_model, d_model, g_tx,
    d_tx)."""
    device = resolve_device(device)
    T_out = sample_batch.mels.shape[2]
    if T_out % hp.n_frames_per_step:
        raise ValueError(f"sample batch T_out {T_out} is not a multiple of "
                         f"n_frames_per_step {hp.n_frames_per_step}")
    return wrap_models(hp, Tacotron2(hp, device=device, seed=seed),
                       make_discriminator(hp, device=device, seed=seed + 1),
                       seed)


# Conv biases that feed a batch-statistics BatchNorm: the normalization
# removes them, so their exact gradient is 0 and any two implementations
# hold float32 rounding noise there, which Adam's first step scales up to
# the learning rate.
BN_FED_BIAS = re.compile(r"^(encoder|postnet)\.convs\.\d+\.conv\.bias$")


def compare_states(state, ref, *, moment_tol, param_rtol, param_atol, floor,
                   noise_tol, stats_tol, what="", root_floor=0.0,
                   tensor_tol=None):
    """Holds ``state`` after training steps against ``ref`` after the same
    steps from the same start (either may be on any device). Raises
    AssertionError at a mismatch; else returns the worst error of each kind,
    as a fraction of its tolerance, with the tensor it was found in:

      * the step and update counts are equal;
      * G's BatchNorm running statistics agree within ``stats_tol``,
        relative and absolute;
      * each parameter's Adam first moment (its gradient) agrees within
        ``moment_tol`` of itself plus ``moment_tol`` of the tensor's
        largest entry, its second moment within twice that;
      * its value agrees within ``param_rtol`` / ``param_atol`` wherever
        Adam's step is conditioned: the root of the bias-corrected second
        moment at least ``floor`` of the tensor's largest. Below that (a
        gradient near ``EPS``) a float32 rounding of the gradient moves the
        update by up to the learning rate on either side, so the value is
        held through its moments alone. ``root_floor`` adds an absolute
        leg: a root below it (100 ``EPS``, say) is near ``EPS`` however
        large the tensor's largest, and is held the same way;
      * the conv biases before a training-mode BatchNorm (``BN_FED_BIAS``)
        hold noise only: both first moments under ``noise_tol`` of the
        model's largest first moment (the ``bn_fed_bias_noise`` entry is
        that share itself). With ``noise_tol=None`` they are held as every
        other parameter is: a step with rollouts runs the encoder and the
        postnet with running statistics too, which gives those biases a
        gradient.

    ``tensor_tol`` maps tensors by name (``"G embedding"``, the names the
    errors give) to a ``moment_tol``, ``noise_tol``, ``param_rtol`` or
    ``param_atol`` of their own, as ``{"G embedding": {"moment_tol":
    5e-5}}``; a name that matches no parameter raises."""
    counts =[(s.step, s.g_opt_state.count, s.d_opt_state.count)
              for s in (state, ref)]
    if counts[0] != counts[1]:
        raise AssertionError(f"{what}: step and update counts {counts}")
    worst = {k: (0.0, "") for k in ("stats", "first_moment",
                                    "second_moment", "param")}
    worst["bn_fed_bias_noise"] = 0.0
    own_tol = dict(tensor_tol or {})

    def check(kind, a, b, rtol, atol, where):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        diff = (a - b).abs()
        frac = torch.where(diff == 0, 0.0, diff / (rtol * b.abs() + atol))
        err = frac.max().item() if frac.numel() else 0.0
        worst[kind] = max(worst[kind], (err, where))
        if not err <= 1:
            raise AssertionError(f"{what}: {where} ({kind}) off by {err:.3g}"
                                 " of its tolerance")

    for (name, b), c in zip(state.g_model.named_buffers(),
                            ref.g_model.buffers()):
        check("stats", b, c, stats_tol, stats_tol, f"G {name}")
    for side, model, r_model, opt, r_opt in (
            ("G", state.g_model, ref.g_model, state.g_opt_state,
             ref.g_opt_state),
            ("D", state.d_model, ref.d_model, state.d_opt_state,
             ref.d_opt_state)):
        bc2 = 1 - B2 ** r_opt.count
        largest = max(m.abs().max().item() for m in r_opt.mu)
        for (name, p), q, m, r_m, v, r_v in zip(
                model.named_parameters(), r_model.parameters(), opt.mu,
                r_opt.mu, opt.nu, r_opt.nu):
            where = f"{side} {name}"
            own = own_tol.pop(where, {})
            tol = own.get("moment_tol", moment_tol)
            if noise_tol is not None and BN_FED_BIAS.match(name):
                peak = max(m.abs().max().item(), r_m.abs().max().item())
                noise = (peak / largest if largest
                         else 0.0 if peak == 0 else math.inf)
                worst["bn_fed_bias_noise"] = max(
                    worst["bn_fed_bias_noise"], noise)
                if not noise <= own.get("noise_tol", noise_tol):
                    raise AssertionError(f"{what}: {where} first moment "
                                         f"{noise:.3g} of the largest")
                continue
            top = r_m.abs().max().item()
            check("first_moment", m, r_m, tol, tol * top, where)
            check("second_moment", v, r_v, 2 * tol,
                  2 * tol * r_v.max().item(), where)
            held = torch.ones(q.shape, dtype=torch.bool)
            if r_opt.count:  # not stepped: all of it
                root = torch.sqrt(r_v.detach().cpu() / bc2)
                held = (root >= floor * root.max()) & (root >= root_floor)
            check("param", p.detach().cpu()[held], q.detach().cpu()[held],
                  own.get("param_rtol", param_rtol),
                  own.get("param_atol", param_atol), where)
    if own_tol:
        raise ValueError(f"{what}: tensor_tol names no parameter: "
                         f"{sorted(own_tol)}")
    return worst

