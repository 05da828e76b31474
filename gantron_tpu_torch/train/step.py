"""Generator, discriminator and eval steps (port of
gantron_tpu/train/step.py), and Flowtron's training step
(``make_flowtron_step``).

Each step is eager PyTorch: forward, losses, ``torch.autograd.grad`` and the
Adam update (train/state.py) on the state's device. The G/D alternation
schedule belongs to the training loop, not here.

  * ``real``/``fake`` Wasserstein signs default to +1/-1;
  * the discriminator's gradient is clipped at ``clipping_value`` (the
    reference's clip before backward() was a no-op; the JAX package
    implements the evident intent, and so does the port);
  * learning rates are arguments of each step;
  * mixed precision (``fp16_run``, or ``compute_dtype="bfloat16"``) runs
    the forward passes on bfloat16 copies of the float32 parameters and
    inputs (the copies are differentiable casts, so gradients reach the
    float32 masters), and the losses in float32 on outputs cast back; Adam
    state and BatchNorm statistics stay float32. Unlike ``torch.autocast``,
    every op of the forward runs in bfloat16, as in the JAX step;
  * adversarial rollouts and the identification machinery (the InfoGAN
    style reconstruction, the diversity pair, the per-dim flip decodes of
    the code terms, the factor-aware rescue's actuators) differentiate
    through ``Tacotron2.rollout``; their draws come from the state's noise
    generator or are passed in (``draws``); rollouts through int8 weights
    are refused, as in the JAX package;
  * ``deferred_dw`` (on by default, as in the JAX package) takes the
    teacher-forced decoder's backward as JAX's does: the five big in-loop
    weights are detached, zero-valued offsets added to each step's gates
    return each step's gate gradient, and ``apply_deferred_dw`` rebuilds
    each weight's gradient after the backward with one matmul over
    steps x B rows (``make_dw_offsets``); rollouts keep plain autograd.
    ``scan_unroll`` shapes the JAX package's compiled scan; eager PyTorch
    has no scan to unroll, so the port accepts it and ignores it;
  * in a process group (data parallel) each rank steps on its rows of the
    global batch: the training BatchNorm's statistics are the global
    batch's, the parameter gradients are averaged over the ranks after
    ``torch.autograd.grad`` (the gradient penalty's inner gradient stays
    local) and before clipping and Adam, and the metrics are the global
    batch's (parallel/distributed.py has the convention). No
    ``DistributedDataParallel``: its hooks do not serve
    ``torch.autograd.grad`` on a ``functional_call``.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from gantron_tpu_torch.losses import (flowtron_loss, gradient_penalty,
                                      tacotron2_loss)
from gantron_tpu_torch.models.discriminator import LinearDiscriminator
from gantron_tpu_torch.parallel.distributed import (all_reduce_mean_,
                                                    in_group, process_count,
                                                    process_index)
from gantron_tpu_torch.parallel.mesh import shard_rows
from gantron_tpu_torch.train.state import global_norm
from gantron_tpu_torch.utils.profiling import span, spanned


class Batch(NamedTuple):
    """One padded, bucketed batch (layout mirrors reference TextMelCollate
    output, data_utils.py:88-131): numpy arrays from ``data.dataset.collate``
    or, after ``to_device``, tensors."""

    text: np.ndarray            # (B, T_in) int32
    text_lengths: np.ndarray    # (B,) int32
    mels: np.ndarray            # (B, n_mel, T_out) float32
    gate: np.ndarray            # (B, T_out) float32
    speaker: np.ndarray         # (B,) int32
    emotions: np.ndarray        # (B, 5) float32
    output_lengths: np.ndarray  # (B,) int32


def to_device(batch: Batch, device) -> Batch:
    """The batch as tensors on ``device``: ids and lengths int64, the rest
    float32."""
    def put(x, dtype):
        return torch.as_tensor(np.asarray(x)).to(device, dtype)

    return Batch(
        text=put(batch.text, torch.long),
        text_lengths=put(batch.text_lengths, torch.long),
        mels=put(batch.mels, torch.float32),
        gate=put(batch.gate, torch.float32),
        speaker=put(batch.speaker, torch.long),
        emotions=put(batch.emotions, torch.float32),
        output_lengths=put(batch.output_lengths, torch.long))


def pad_mel_to_window(mel_bct, window):
    """Zero-pad (B, n_mel, T) so T is a multiple of the discriminator
    window."""
    pad = (-mel_bct.shape[2]) % window
    return F.pad(mel_bct, (0, pad)) if pad else mel_bct


class _Method(nn.Module):
    """``module.<name>`` as the ``forward`` of a module that holds
    ``module``, so that ``functional_call`` can run it on parameter
    copies."""

    def __init__(self, module, name):
        super().__init__()
        self.module = module
        self.name = name

    def forward(self, *args, **kwargs):
        return getattr(self.module, self.name)(*args, **kwargs)


def _forward(module, dtype, *args, method="forward", **kwargs):
    """``module.<method>(*args, **kwargs)``, with its parameters as ``dtype``
    copies when ``dtype`` is not their own (buffers stay as they are). The
    copies are differentiable casts, so gradients reach the float32
    parameters."""
    if dtype == next(module.parameters()).dtype:
        return getattr(module, method)(*args, **kwargs)
    params = {n: p.to(dtype) for n, p in module.named_parameters()}
    if method == "forward":
        return functional_call(module, params, args, kwargs)
    return functional_call(_Method(module, method),
                           {"module." + n: p for n, p in params.items()},
                           args, kwargs)


# The offsets of the deferred-dW backward, in the order the G step asks
# for their gradients, and the decoder's five weights they stand in for.
DW_OFFSETS = ("z1", "z2", "zq")
DEFERRED_WEIGHTS = ("decoder.attention_rnn.w_ih", "decoder.attention_rnn.w_hh",
                    "decoder.query_w", "decoder.decoder_rnn.w_ih",
                    "decoder.decoder_rnn.w_hh")


def make_dw_offsets(hp, batch_size, t_out, dtype, device):
    """Zero-valued per-step offsets of the decoder's gates for the
    deferred-dW backward (``Decoder.forward``), each of (steps, B,
    4 attention_rnn_dim), (steps, B, 4 decoder_rnn_dim) and (steps, B,
    attention_dim), requiring grad. Each is a copy of a leaf, not the leaf
    itself: a module hook that registers gradient hooks on its inputs
    (``FlopCounterMode``'s module tracker, ``cli/bench.py``) cannot do so
    on a leaf under ``torch.autograd.grad``."""
    steps = t_out // hp.n_frames_per_step

    def z(d):
        return torch.zeros((steps, batch_size, d), dtype=dtype, device=device,
                           requires_grad=True).clone()

    return dict(z1=z(4 * hp.attention_rnn_dim), z2=z(4 * hp.decoder_rnn_dim),
                zq=z(hp.attention_dim))


def apply_deferred_dw(hp, grads, names, dw_aux, d_off):
    """``grads`` (aligned with the parameter ``names``) with the gradients
    of the decoder's five detached in-loop weights added.

    Each in-loop product ``gates_t = x_t @ W`` gives its weight
    ``dW = sum_t x_t^T dgates_t``, where ``dgates_t`` is the gradient of
    that step's offset (``d_off``): one matmul over steps x B rows a weight,
    summed in float32 (from bfloat16 operands under ``fp16_run``; float64
    for a float64 state). ``x_t`` at a step's entry is the previous step's
    output, zero at t = 0, so every input comes from the loop's outputs
    (``dw_aux``) by a one-step shift. Rows [:P] of the attention LSTM's ``w_ih`` (the prenet
    projection, taken before the loop) keep their autograd gradient; its
    rows [P:] get the context's. A weight that autograd left without a
    gradient (no rollout reads it) gets the rebuilt one alone."""
    attn_hs, dec_hs, contexts = (dw_aux[k] for k in
                                 ("attn_hs", "dec_hs", "contexts"))
    dz1, dz2, dzq = (d_off[k] for k in DW_OFFSETS)
    P = hp.prenet_dim

    def shift(x):
        return torch.cat([torch.zeros_like(x[:1]), x[:-1]])

    def ein(x, dz):
        sums = torch.promote_types(x.dtype, torch.float32)
        return (x.reshape(-1, x.shape[-1]).to(sums).T
                @ dz.reshape(-1, dz.shape[-1]).to(sums))

    dwc = ein(shift(contexts), dz1)
    dw = dict(zip(DEFERRED_WEIGHTS, (
        torch.cat([dwc.new_zeros(P, dwc.shape[1]), dwc]),
        ein(shift(attn_hs), dz1),
        ein(attn_hs, dzq),
        torch.cat([ein(attn_hs, dz2), ein(contexts, dz2)]),
        ein(shift(dec_hs), dz2))))
    out = list(grads)
    for i, n in enumerate(names):
        if n in dw:
            out[i] = dw[n] if out[i] is None else out[i] + dw[n]
    return out


def _adv_loss(discriminator, mel_bct, lengths, generator, dtype, train=True):
    return _forward(discriminator, dtype, mel_bct.to(dtype), lengths, train,
                    generator).to(torch.promote_types(dtype, torch.float32))


def _local_rows(x, B):
    """This process's rows of an injected draw (a tensor, or a NamedTuple
    of them) given for the global batch of ``B`` rows a process; ``x`` as
    it is when it already has ``B`` rows."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(_local_rows(v, B) for v in x))
    world = process_count()
    if world > 1 and x.shape[0] == B * world:
        return shard_rows(x, process_index(), world)
    return x


def _global_metrics(metrics, replicated=()):
    """The global batch's metrics in a process group: each rank's shard
    means averaged over the ranks, one all_reduce; ``replicated`` names
    those that are equal on every rank already (the grad norms of the
    reduced gradients)."""
    if not in_group():
        return metrics
    keys = [k for k in metrics if k not in replicated]
    values, = all_reduce_mean_(
        [torch.stack([metrics[k].float() for k in keys])])
    return {**metrics, **dict(zip(keys, values.unbind()))}


# -- the identification machinery's draws -------------------------------------
# Each function takes a ``torch.Generator`` where the JAX package takes a
# key, and accepts its raw draws instead (``draw``/``draws``): the same
# uniforms or integers give the same codes as the JAX functions, which the
# parity tests use, since Philox and Threefry draw differently.
def _grid(k, code_levels):
    return (k.float() + 0.5) / code_levels


def _levels_of(code, code_levels):
    return torch.round(code * code_levels - 0.5).long()


def draw_code(generator, shape, code_levels, device=None, draw=None):
    """Code-dim draw: U[0, 1) for a continuous code (``code_levels`` 0) or
    the discrete grid (k + 0.5) / L with k uniform in [0, L). ``draw``: the
    uniforms or the integers k."""
    if draw is None:
        draw = (torch.rand(shape, generator=generator, device=device)
                if code_levels == 0 else
                torch.randint(0, code_levels, shape, generator=generator,
                              device=device))
    return draw.float() if code_levels == 0 else _grid(draw, code_levels)


class RedrawDraws(NamedTuple):
    """The raw draws of one ``redraw_code``. ``off``: offsets in
    [1, code_levels) of the code's shape (U[0, 1) redraws for a continuous
    code). With a subset of more than one dim: ``mask_u`` U[0, 1) of the
    code's shape (a dim joins where it is below its probability), ``force``
    the forced dim, uniform in [0, dims), of shape code.shape[:-1], and
    ``gumbel`` Gumbel(0, 1) noise of the code's shape for a weighted force
    (None without weights)."""

    off: torch.Tensor
    mask_u: torch.Tensor = None
    force: torch.Tensor = None
    gumbel: torch.Tensor = None


def _gumbel(shape, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def _weighted_index(dim_weights, uniform_idx, gumbel):
    """The index drawn ~ ``dim_weights`` (categorical, as the Gumbel argmax);
    UNIFORM weights (all equal) take ``uniform_idx`` exactly, so an unarmed
    rescue controller keeps the unweighted draws."""
    w = dim_weights
    weighted = torch.argmax(torch.log(torch.clamp(w, min=1e-9)) + gumbel,
                            dim=-1)
    return torch.where(torch.all(w == w[0]), uniform_idx, weighted)


def redraw_code(generator, code, code_levels, subset=False, dim_weights=None,
                draws: RedrawDraws = None):
    """Diversity-pair code redraw (config.py diversity_weight).

    Discrete (code_levels >= 2): shift by a nonzero offset mod L so the pair
    always differs (a same-code pair decodes identically under the shared
    dropout). Continuous (code_levels == 0): an independent U[0, 1) redraw.

    ``subset=True`` (config.py diversity_subset_redraw) shifts a random
    NONEMPTY subset of the code dims: each dim joins with probability 0.5
    and one drawn dim always does. ``dim_weights`` (subset mode only; the
    factor-aware rescue's (dims,) weights): the forced dim is drawn
    ~ ``dim_weights`` and the others join with probability
    ``0.5 * w_d / max(w)``; UNIFORM weights take the unweighted draws
    exactly. ``draws``: the raw draws (``RedrawDraws``) in place of those
    from ``generator``."""
    dims = code.shape[-1]
    use_subset = subset and dims > 1 and code_levels != 0
    if draws is None:
        dev = code.device
        off = (torch.rand(code.shape, generator=generator, device=dev)
               if code_levels == 0 else
               torch.randint(1, code_levels, code.shape, generator=generator,
                             device=dev))
        draws = RedrawDraws(off)
        if use_subset:
            draws = draws._replace(
                mask_u=torch.rand(code.shape, generator=generator,
                                  device=dev),
                force=torch.randint(0, dims, code.shape[:-1],
                                    generator=generator, device=dev),
                gumbel=(None if dim_weights is None
                        else _gumbel(code.shape, generator, dev)))
    if code_levels == 0:
        return draws.off.float()
    off = draws.off
    if use_subset:
        if dim_weights is None:
            mask = draws.mask_u < 0.5
            force_idx = draws.force
        else:
            w = torch.as_tensor(dim_weights, dtype=torch.float32,
                                device=code.device)
            mask = draws.mask_u < 0.5 * w / torch.clamp(w.max(), min=1e-9)
            force_idx = _weighted_index(w, draws.force, draws.gumbel)
        force = F.one_hot(force_idx, dims).bool()
        off = torch.where(mask | force, off, 0)
    return _grid((_levels_of(code, code_levels) + off) % code_levels,
                 code_levels)


def shift_code_masked(generator, code, code_levels, mask, draw=None):
    """Shift EXACTLY the masked code dims to a different value (discrete:
    a nonzero offset mod L; continuous: an independent U[0, 1) redraw);
    other dims unchanged. ``draw``: offsets in [1, L) (uniforms for a
    continuous code) of the code's shape."""
    if draw is None:
        draw = (torch.rand(code.shape, generator=generator,
                           device=code.device)
                if code_levels == 0 else
                torch.randint(1, code_levels, code.shape,
                              generator=generator, device=code.device))
    if code_levels == 0:
        return torch.where(mask, draw.float(), code)
    off = torch.where(mask, draw, 0)
    return _grid((_levels_of(code, code_levels) + off) % code_levels,
                 code_levels)


def _frame_mask(T, lengths):
    return (torch.arange(T, device=lengths.device)[None, :]
            < lengths[:, None]).float()[:, None, :]


def delta_cos(base_mel, mel_i, mel_j, len_base, len_i, len_j):
    """Per-sample cosine between the two per-dim output deltas of a
    modularity triple, over the frames any of the three decodes emits. A
    dead dim (|delta| ~ 0) gives cos ~ 0 (the 1e-6 floor of the
    denominator)."""
    m3 = _frame_mask(base_mel.shape[2],
                     torch.maximum(torch.maximum(len_base, len_i), len_j))
    d_i = (mel_i - base_mel) * m3
    d_j = (mel_j - base_mel) * m3
    num = torch.sum(d_i * d_j, dim=(1, 2))
    den = torch.sqrt(torch.sum(d_i * d_i, dim=(1, 2))
                     * torch.sum(d_j * d_j, dim=(1, 2)))
    return num / torch.clamp(den, min=1e-6)


def delta_orthogonality(base_mel, mel_i, mel_j, len_base, len_i, len_j):
    """Mean |cosine| between the two per-dim output deltas of a modularity
    triple (config.py code_modularity_weight)."""
    return torch.mean(torch.abs(delta_cos(base_mel, mel_i, mel_j, len_base,
                                          len_i, len_j)))


def delta_additivity(base_mel, mel_i, mel_j, mel_ij, len_base, len_i, len_j,
                     len_ij):
    """Masked mean-L1 of the mixed second difference G(z_ij) - G(z_i) -
    G(z_j) + G(z) (config.py code_additivity_weight), over the frames any
    of the four decodes emits, in mel-L1 units."""
    quad = torch.maximum(torch.maximum(len_base, len_i),
                         torch.maximum(len_j, len_ij))
    resid = (mel_ij - mel_i - mel_j + base_mel) * _frame_mask(
        base_mel.shape[2], quad)
    return torch.mean(torch.sum(torch.abs(resid), dim=(1, 2))
                      / (base_mel.shape[1] * torch.clamp(quad, min=1)))


# The G step's metrics of the rollout and identification terms (the JAX
# package's names and order).
IDENTIFICATION_METRICS = ("rollout_adversarial_loss",
                          "style_reconstruction_loss",
                          "style_diversity_ratio", "code_modularity_penalty",
                          "code_additivity_penalty", "code_orthogonal_sin")


class FlipDraws(NamedTuple):
    """The raw draws of the per-dim flip decodes (code_modularity_weight,
    code_additivity_weight, code_orthogonal_reward): ``i`` the first dim,
    uniform in [0, dims), (B,); ``gumbel`` (B, dims) Gumbel noise for a
    weighted ``i`` (None without weights); ``j`` the second dim's offset
    from ``i``, uniform in [1, dims), (B,); ``shift_i``/``shift_j`` the
    ``shift_code_masked`` draws of each flip, of the code's shape."""

    i: torch.Tensor
    gumbel: torch.Tensor
    j: torch.Tensor
    shift_i: torch.Tensor
    shift_j: torch.Tensor


def _flip_draws(generator, code, code_levels, weighted) -> FlipDraws:
    B, dims, dev = code.shape[0], code.shape[-1], code.device

    def shift():
        return (torch.rand(code.shape, generator=generator, device=dev)
                if code_levels == 0 else
                torch.randint(1, code_levels, code.shape,
                              generator=generator, device=dev))

    return FlipDraws(
        i=torch.randint(0, dims, (B,), generator=generator, device=dev),
        gumbel=_gumbel((B, dims), generator, dev) if weighted else None,
        j=torch.randint(1, dims, (B,), generator=generator, device=dev),
        shift_i=shift(), shift_j=shift())


def _check_config(hp, generator, discriminator):
    """The JAX package's guards (its make_train_steps), in its order, with
    its exception types and messages."""
    if (hp.gradient_penalty_lambda > 0
            and isinstance(discriminator, LinearDiscriminator)):
        raise NotImplementedError(
            "gradient_penalty_lambda > 0 is not supported with "
            "discriminator_type='linear'; use the conv discriminator or "
            "disable the gradient penalty")
    roll_flag = bool(hp.adversarial_rollouts)
    style_recon = float(hp.style_reconstruction_weight) > 0
    if style_recon and not roll_flag:
        raise ValueError(
            "style_reconstruction_weight > 0 requires "
            "adversarial_rollouts=True: the InfoGAN head reconstructs the "
            "style from the FREE-RUNNING rollout mel (a teacher-forced mel "
            "carries the mode in its forced history, not the latent — "
            "docs/TRAINING_EVIDENCE.md)")
    if style_recon and generator.noise_size == 0:
        raise ValueError(
            "style_reconstruction_weight > 0 requires use_noise=True with "
            "noise_size > 0 (there is no latent to identify)")
    diversity = float(hp.diversity_weight) > 0
    if diversity and not roll_flag:
        raise ValueError(
            "diversity_weight > 0 requires adversarial_rollouts=True: the "
            "regularizer compares two FREE-RUNNING decodes of the same "
            "batch under a shared dropout key (a teacher-forced decode is "
            "pinned to the forced history, so there is nothing to diversify)")
    if diversity and generator.noise_size == 0:
        raise ValueError(
            "diversity_weight > 0 requires use_noise=True with "
            "noise_size > 0 (there is no latent to diversify over)")
    actuator = str(hp.factor_rescue_actuator or "redraw")
    if actuator not in ("redraw", "recon"):
        raise ValueError(
            f"factor_rescue_actuator={actuator!r} must be 'redraw' "
            "(bias the subset-redraw/probe draws) or 'recon' (weight the "
            "per-dim style-reconstruction errors) — config.py "
            "factor_rescue_actuator")
    floor = float(hp.factor_rescue_floor or 0.0)
    if actuator == "recon" and floor > 0 and not style_recon:
        raise ValueError(
            "factor_rescue_actuator='recon' with factor_rescue_floor > 0 "
            "requires style_reconstruction_weight > 0: the recon actuator "
            "weights exactly those per-dim reconstruction errors")
    modularity = float(hp.code_modularity_weight) > 0
    additivity = float(hp.code_additivity_weight) > 0
    if modularity or additivity or hp.code_orthogonal_reward:
        flag = ("code_modularity_weight" if modularity
                else "code_additivity_weight" if additivity
                else "code_orthogonal_reward")
        if not diversity or float(hp.diversity_cap) <= 0:
            raise ValueError(
                f"{flag} > 0 requires diversity_weight > 0 "
                "and diversity_cap > 0: the per-dim flip decodes extend "
                "the saturating diversity stage (config.py "
                f"{flag})")
        if int(hp.style_code_dims) < 2:
            raise ValueError(
                f"{flag} > 0 requires style_code_dims >= 2: "
                "modular binding is only defined between distinct code "
                "dims")
    if int(hp.style_code_dims) > generator.noise_size:
        raise ValueError(
            f"style_code_dims={hp.style_code_dims} exceeds noise_size="
            f"{generator.noise_size}: the code is a PREFIX of the style "
            "vector (config.py style_code_dims)")
    if int(hp.style_code_levels) == 1:
        raise ValueError(
            "style_code_levels=1 is a constant code (nothing to identify); "
            "use 0 for continuous or >= 2 for a discrete grid")
    if floor > 0 and not hp.diversity_subset_redraw:
        raise ValueError(
            "factor_rescue_floor > 0 requires diversity_subset_redraw=True: "
            "the factor-aware rescue's actuator is the weighted subset "
            "redraw (config.py factor_rescue_floor)")
    if ((roll_flag or style_recon or diversity)
            and hp.quantized_inference):
        # The int8 weights round-trip through quantize_per_channel, whose
        # round() has zero gradient: rollout training would silently stop
        # learning the recurrence matrices.
        raise NotImplementedError(
            "adversarial_rollouts=True cannot train through "
            "quantized_inference=True (int8 rounding kills the rollout "
            "gradients); quantize for serving only")


def make_train_steps(hp, generator, discriminator, g_tx, d_tx,
                     real: float = 1.0):
    """The generator, discriminator and eval steps for these models and
    optimizers (``generator``/``discriminator`` are the state's models).

    ``g_step`` and ``d_step`` keep the JAX signatures, state in and state
    out, but they are not functional: they update the state they are given
    in place (its models' parameters and BatchNorm statistics, its Adam
    moments, its step count and generators) and return that same object.
    To take two steps from one state, build the state twice."""
    fake = -real
    _check_config(hp, generator, discriminator)
    # The forward's dtype; the losses run in float32, or in float64 for a
    # state whose models were converted to float64 (``.double()``), which
    # then takes float64 steps throughout.
    dtype = (torch.bfloat16 if hp.compute_dtype == "bfloat16" or hp.fp16_run
             else next(generator.parameters()).dtype)
    loss_dtype = torch.promote_types(dtype, torch.float32)
    W = hp.discriminator_window
    roll_flag = bool(hp.adversarial_rollouts)
    rollouts = roll_flag and hp.d_freq > 0
    recon_w = float(hp.style_reconstruction_weight)
    div_w, div_tau = float(hp.diversity_weight), float(hp.diversity_tau)
    div_cap = float(hp.diversity_cap)
    mod_w = float(hp.code_modularity_weight)
    add_w = float(hp.code_additivity_weight)
    style_recon, diversity = recon_w > 0, div_w > 0
    modularity, additivity = mod_w > 0, add_w > 0
    ortho_reward = bool(hp.code_orthogonal_reward)
    flips = modularity or additivity or ortho_reward
    roll_decode = rollouts or style_recon or diversity
    code_dims = int(hp.style_code_dims) or generator.noise_size
    code_levels = int(hp.style_code_levels)
    actuator = str(hp.factor_rescue_actuator or "redraw")
    deferred = bool(hp.deferred_dw)

    @spanned("g_step")
    def g_step(state, batch: Batch, g_lr, attn_weight, ident_scale=1.0,
               dim_weights=None, style=None, draws=None):
        """One generator update of ``state`` (in place; returned). ``batch``
        holds tensors on the state's device. ``style``: optional
        (B, 1, noise_size) in place of the teacher-forced pass's draw from
        the state's noise generator. In a process group ``style`` and
        ``draws`` may hold the global batch's rows: each rank takes its
        own.

        With ``hp.adversarial_rollouts`` (or an identification term) the
        batch is also decoded free-running with autograd history
        (``Tacotron2.rollout``, as many steps as the batch has mel frames
        over K): D scores the rollout, the InfoGAN style encoder
        reconstructs its style code, and the diversity pair and the per-dim
        flip decodes re-decode it with the prenet's dropout masks shared
        (one generator state, restored before each decode), so that they
        differ only by the code. ``ident_scale`` (0 during
        ``identification_warmup``, else the rescue controller's scale)
        multiplies the identification terms; ``dim_weights``: the
        factor-aware rescue's (code_dims,) weights, routed by
        ``hp.factor_rescue_actuator`` ("redraw" biases the subset redraw
        and the flip dims, "recon" weights the per-dim reconstruction
        errors; None = uniform). ``draws``: optional dict of the rollout's
        draws in place of those from the state's noise generator: "style"
        (B, 1, noise_size) with its code dims on the grid, "redraw" a
        ``RedrawDraws``, "flip" a ``FlipDraws``.

        Returns (state, metrics, (fake_mel, fake_lengths)) for the
        discriminator step (float32, detached): the teacher-forced postnet
        mel and the batch's lengths, or the rollout's and its gate-decided
        lengths with ``hp.adversarial_rollouts``."""
        G, D = state.g_model, state.d_model
        g_drop, g_noise = state.dropout_generator, state.noise_generator
        device = batch.mels.device
        B = batch.text.shape[0]
        style = _local_rows(style, B)
        draws = {k: _local_rows(v, B) for k, v in (draws or {}).items()}
        if roll_decode:
            # Before the teacher-forced pass, which updates the BatchNorm
            # running statistics that the rollout's encoder and postnet
            # read: the rollout sees the step's starting statistics, as
            # in the JAX step.
            with span("g_step.identification"):
                ident_metrics, roll_adv, ident, roll_pair = _identification(
                    G, D, batch, draws, ident_scale, dim_weights, g_drop,
                    g_noise, device)
        offsets = (make_dw_offsets(hp, B, batch.mels.shape[2], dtype, device)
                   if deferred else None)
        with span("g_step.forward"):
            out = _forward(G, dtype, batch.text, batch.text_lengths,
                           batch.mels.to(dtype), batch.speaker,
                           batch.emotions, batch.output_lengths, train=True,
                           style=style, generator=g_drop,
                           noise_generator=g_noise, dw_offsets=offsets)
            if deferred:
                out, dw_aux = out
            out = [o.to(loss_dtype) for o in out]
        with span("g_step.loss"):
            mel_l, gate_l, attn_l = tacotron2_loss(
                out, (batch.mels, batch.gate), batch.text_lengths,
                batch.output_lengths)
            taco = mel_l + gate_l
            adv = torch.zeros((), device=taco.device)
            if hp.d_freq > 0:
                adv = real * _adv_loss(D, pad_mel_to_window(out[1], W),
                                       batch.output_lengths, g_drop, dtype)
            total = taco + adv
            fake_pair = (out[1], batch.output_lengths)
            metrics = {}
            if roll_decode:
                metrics = ident_metrics
                total = total + roll_adv + ident
                fake_pair = roll_pair or fake_pair
            total = total + attn_weight * attn_l
        names, params = zip(*G.named_parameters())
        if deferred:
            # The five detached weights reach the loss only through a
            # rollout, if any: autograd may leave them without a gradient,
            # and apply_deferred_dw fills it in; any other parameter left
            # without one is refused, as the strict form refuses it.
            with span("g_step.backward"):
                grads = torch.autograd.grad(
                    total, list(params) + [offsets[k] for k in DW_OFFSETS],
                    allow_unused=True)
            d_off = dict(zip(DW_OFFSETS, grads[len(params):]))
            grads = grads[:len(params)]
            unused = [n for n, g in zip(names, grads)
                      if g is None and n not in DEFERRED_WEIGHTS]
            if unused:
                raise RuntimeError(f"parameters {unused} were not used in "
                                   "the graph of the G step's loss")
            with span("g_step.deferred_dw"):
                grads = apply_deferred_dw(hp, grads, names, dw_aux, d_off)
        else:
            with span("g_step.backward"):
                grads = torch.autograd.grad(total, params)
        with span("g_step.all_reduce"):
            grads = all_reduce_mean_(grads)
        with span("g_step.update"):
            grad_norm = global_norm(grads)
            state.g_opt_state = g_tx.update(grads, state.g_opt_state,
                                            list(params), g_lr)
        state.step += 1
        metrics = dict(mel_loss=mel_l, gate_loss=gate_l,
                       attention_loss=attn_l, adversarial_loss=adv,
                       taco_loss=taco, generator_loss=total,
                       **metrics, grad_norm=grad_norm)
        metrics = _global_metrics({k: v.detach() for k, v in metrics.items()},
                                  replicated=("grad_norm",))
        return state, metrics, (fake_pair[0].detach(), fake_pair[1])

    def _identification(G, D, batch, draws, ident_scale, dim_weights,
                        g_drop, g_noise, device):
        """The rollout and identification terms of the G step. Returns
        ({metric: value}, the rollout's adversarial loss, ``ident_scale``
        times the weighted identification terms, the rollout's fake pair
        or None)."""
        redraw_weights = recon_weights = None
        if dim_weights is not None:
            dim_weights = torch.as_tensor(dim_weights, dtype=torch.float32,
                                          device=device)
            if actuator == "redraw":
                redraw_weights = dim_weights
            else:
                recon_weights = dim_weights
        B = batch.text.shape[0]
        steps = batch.mels.shape[2] // hp.n_frames_per_step
        roll_style = draws.get("style")
        if roll_style is None and G.noise_size > 0:
            roll_style = torch.rand((B, 1, G.noise_size), generator=g_noise,
                                    device=device)
            if code_levels:
                roll_style[:, :, :code_dims] = draw_code(
                    g_noise, (B, 1, code_dims), code_levels, device)
        if roll_style is not None:
            roll_style = roll_style.to(device, torch.float32)
        roll_state = g_drop.get_state()

        def decode(style_x, drop):
            return _forward(G, dtype, batch.text, style_x, batch.emotions,
                            batch.speaker, steps, method="rollout",
                            text_lengths=batch.text_lengths, generator=drop)

        def again(style_x):
            # The dropout masks of the first rollout, drawn anew from its
            # generator state: the decodes differ exactly by the code.
            drop = torch.Generator(device=device)
            drop.set_state(roll_state)
            r = decode(style_x, drop)
            return r[1].float(), r[4]

        roll = decode(roll_style, g_drop)
        roll_mel, roll_lengths = roll[1].float(), roll[4]
        zero = torch.zeros((), device=device)
        roll_adv = recon_loss = div_loss = mod_pen = add_pen = zero
        terms = {}
        fake_pair = None
        if rollouts:
            roll_adv = real * _adv_loss(
                D, pad_mel_to_window(roll_mel, W), roll_lengths, g_drop,
                dtype)
            fake_pair = (roll_mel, roll_lengths)
            terms["rollout_adversarial_loss"] = roll_adv
        if style_recon:
            pred = _forward(G, dtype, roll[1], roll_lengths,
                            method="predict_style").float()
            recon_err = (pred - roll_style[:, 0, :code_dims]) ** 2
            if recon_weights is not None:
                w = recon_weights
                recon_loss = torch.where(
                    torch.all(w == w[0]), torch.mean(recon_err),
                    torch.mean(recon_err * (w / torch.mean(w))[None, :]))
            else:
                recon_loss = torch.mean(recon_err)
            terms["style_reconstruction_loss"] = recon_loss
        if diversity:
            T_roll = roll_mel.shape[2]

            def pair_d_out(mel2, len2):
                # Over each pair's longer emitted length: frames where one
                # decode has stopped and the other has not still count.
                pair_len = torch.maximum(roll_lengths, len2)
                return (torch.sum(torch.abs(roll_mel - mel2)
                                  * _frame_mask(T_roll, pair_len),
                                  dim=(1, 2))
                        / (roll_mel.shape[1] * torch.clamp(pair_len, min=1)))

            code = roll_style[:, :, :code_dims]
            nuis = roll_style[:, :, code_dims:]
            if flips:
                flip = draws.get("flip") or _flip_draws(
                    g_noise, code, code_levels, redraw_weights is not None)
                i_idx = flip.i
                if redraw_weights is not None:
                    i_idx = _weighted_index(redraw_weights, flip.i,
                                            flip.gumbel)
                j_idx = (i_idx + flip.j) % code_dims

                def one_hot(idx):
                    return F.one_hot(idx, code_dims).bool()[:, None, :]

                code_i = shift_code_masked(None, code, code_levels,
                                           one_hot(i_idx), flip.shift_i)
                code_j = shift_code_masked(None, code, code_levels,
                                           one_hot(j_idx), flip.shift_j)
                mel_i, len_i = again(torch.cat([code_i, nuis], dim=-1))
                mel_j, len_j = again(torch.cat([code_j, nuis], dim=-1))
                d_i, d_j = pair_d_out(mel_i, len_i), pair_d_out(mel_j, len_j)
                if ortho_reward:
                    # Each single-dim contrast scaled by the sine between
                    # the two per-dim output deltas.
                    cos = delta_cos(roll_mel, mel_i, mel_j, roll_lengths,
                                    len_i, len_j)
                    ortho_sin = torch.sqrt(torch.clamp(1.0 - cos * cos,
                                                       1e-6, 1.0))
                    rewards = [
                        torch.mean(torch.clamp(d_i * ortho_sin, max=div_cap)),
                        torch.mean(torch.clamp(d_j * ortho_sin, max=div_cap))]
                    terms["code_orthogonal_sin"] = torch.mean(ortho_sin)
                else:
                    rewards = [torch.mean(torch.clamp(d_i, max=div_cap)),
                               torch.mean(torch.clamp(d_j, max=div_cap))]
                if modularity:
                    mod_pen = delta_orthogonality(roll_mel, mel_i, mel_j,
                                                  roll_lengths, len_i, len_j)
                    terms["code_modularity_penalty"] = mod_pen
                if additivity:
                    # The joint flip: both single-dim shifts composed.
                    code_ij = shift_code_masked(None, code_j, code_levels,
                                                one_hot(i_idx), flip.shift_i)
                    mel_ij, len_ij = again(torch.cat([code_ij, nuis], dim=-1))
                    rewards.append(torch.mean(torch.clamp(
                        pair_d_out(mel_ij, len_ij), max=div_cap)))
                    add_pen = delta_additivity(roll_mel, mel_i, mel_j, mel_ij,
                                               roll_lengths, len_i, len_j,
                                               len_ij)
                    terms["code_additivity_penalty"] = add_pen
                div_ratio = sum(rewards) / (len(rewards) * div_cap)
            else:
                redraw = redraw_code(g_noise, code, code_levels,
                                     hp.diversity_subset_redraw,
                                     redraw_weights, draws.get("redraw"))
                mel2, len2 = again(torch.cat([redraw, nuis], dim=-1))
                d_out = pair_d_out(mel2, len2)
                if div_cap > 0:
                    # Saturating reward in [0, 1], no gradient past the cap.
                    div_ratio = torch.mean(torch.clamp(d_out, max=div_cap)) \
                        / div_cap
                else:
                    d_z = torch.mean(torch.abs(code - redraw), dim=(1, 2))
                    div_ratio = torch.mean(torch.clamp(
                        d_out / torch.clamp(d_z, min=1e-6), max=div_tau))
            div_loss = -div_ratio
            terms["style_diversity_ratio"] = div_ratio
        ident = ident_scale * (recon_w * recon_loss + div_w * div_loss
                               + mod_w * mod_pen + add_w * add_pen)
        return ({k: terms[k] for k in IDENTIFICATION_METRICS if k in terms},
                roll_adv, ident, fake_pair)

    @spanned("d_step")
    def d_step(state, real_mel, real_lengths, gen_mel, gen_lengths, d_lr):
        """One discriminator update of ``state`` (in place; returned) on real
        and generated (B, n_mel, T) mels. Returns (state, metrics)."""
        D = state.d_model
        d_drop = state.dropout_generator
        with span("d_step.forward"):
            real_p = pad_mel_to_window(real_mel, W)
            gen_p = pad_mel_to_window(gen_mel.detach(), W)
            real_loss = real * _adv_loss(D, real_p, real_lengths, d_drop,
                                         dtype)
            fake_loss = fake * _adv_loss(D, gen_p, gen_lengths, d_drop, dtype)
            loss = (real_loss + fake_loss) / 2
            gp = torch.zeros((), device=loss.device)
            if hp.gradient_penalty_lambda > 0:
                def disc_scores(x):
                    return D.scores(pad_mel_to_window(x, W).transpose(1, 2),
                                    True, d_drop)

                gp = gradient_penalty(disc_scores, real_p, gen_p,
                                      real_lengths, gen_lengths,
                                      state.noise_generator)
                loss = loss + hp.gradient_penalty_lambda * gp
        params = list(D.parameters())
        with span("d_step.backward"):
            grads = torch.autograd.grad(loss, params)
        with span("d_step.update"):
            grads = all_reduce_mean_(grads)
            grad_norm = global_norm(grads)
            state.d_opt_state = d_tx.update(grads, state.d_opt_state, params,
                                            d_lr)
        state.step += 1
        metrics = dict(discriminator_loss=loss, real_loss=real_loss,
                       fake_loss=fake_loss, gradient_penalty=gp,
                       discriminator_grad_norm=grad_norm)
        return state, _global_metrics(
            {k: v.detach() for k, v in metrics.items()},
            replicated=("discriminator_grad_norm",))

    @torch.no_grad()
    def eval_step(state, batch: Batch, generator):
        """Teacher-forced validation in float32 with running BatchNorm
        statistics; ``generator`` draws the prenet dropout and the noise.
        Returns (metrics, outputs)."""
        out = state.g_model(batch.text, batch.text_lengths, batch.mels,
                            batch.speaker, batch.emotions,
                            batch.output_lengths, train=False,
                            generator=generator, noise_generator=generator)
        mel_l, gate_l, attn_l = tacotron2_loss(
            out, (batch.mels, batch.gate), batch.text_lengths,
            batch.output_lengths)
        return dict(mel_loss=mel_l, gate_loss=gate_l,
                    attention_loss=attn_l), out

    return g_step, d_step, eval_step


def make_flowtron_step(cfg, model, tx):
    """Flowtron's training step for this model (``models/flowtron.py``) and
    optimizer (``train/state.py::wrap_flowtron``): the teacher-forced
    forward over every frame, ``losses.flowtron_loss`` (the flows' loss plus
    the gate's), ``torch.autograd.grad``, then clip -> L2 -> Adam. It updates
    the state it is given in place and returns it."""

    @spanned("flowtron.step")
    def flowtron_step(state, batch: Batch, lr):
        """One update of ``state`` on ``batch`` (tensors on the model's
        device; ``batch.speaker`` the speaker ids). Returns (state,
        metrics)."""
        with span("flowtron.forward"):
            z, log_s, gate, _ = model(
                batch.mels, batch.speaker, batch.text, batch.text_lengths,
                batch.output_lengths, train=True,
                generator=state.dropout_generator)
        with span("flowtron.loss"):
            flow_l, gate_l = flowtron_loss(z, log_s, gate, batch.gate,
                                           batch.output_lengths, cfg.sigma)
            total = flow_l + gate_l
        params = list(model.parameters())
        with span("flowtron.backward"):
            grads = torch.autograd.grad(total, params)
        with span("flowtron.update"):
            grad_norm = global_norm(grads)
            state.opt_state = tx.update(grads, state.opt_state, params, lr)
        state.step += 1
        return state, dict(loss=total.detach(), flow_loss=flow_l.detach(),
                           gate_loss=gate_l.detach(), grad_norm=grad_norm)

    return flowtron_step
