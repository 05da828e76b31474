"""Generator, discriminator and eval steps (port of
gantron_tpu/train/step.py).

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
  * ``deferred_dw`` and ``scan_unroll`` shape the JAX package's compiled
    scan, not the gradients; autograd computes the same gradients directly,
    so the port accepts both flags and ignores them.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from gantron_tpu_torch.losses import gradient_penalty, tacotron2_loss
from gantron_tpu_torch.models.discriminator import LinearDiscriminator
from gantron_tpu_torch.train.state import global_norm


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


def _forward(module, dtype, *args, **kwargs):
    """``module(*args, **kwargs)``, with its parameters as ``dtype`` copies
    when ``dtype`` is not float32 (buffers stay as they are)."""
    if dtype == torch.float32:
        return module(*args, **kwargs)
    params = {n: p.to(dtype) for n, p in module.named_parameters()}
    return functional_call(module, params, args, kwargs)


def _adv_loss(discriminator, mel_bct, lengths, generator, dtype, train=True):
    return _forward(discriminator, dtype, mel_bct.to(dtype), lengths, train,
                    generator).float()


IDENTIFICATION_FLAGS = ("adversarial_rollouts", "style_reconstruction_weight",
                        "diversity_weight", "code_modularity_weight",
                        "code_additivity_weight", "code_orthogonal_reward",
                        "factor_rescue_floor")


def _check_config(hp, generator, discriminator):
    """The JAX package's guards, and a refusal of the identification
    machinery, which the port does not have yet."""
    if (hp.gradient_penalty_lambda > 0
            and isinstance(discriminator, LinearDiscriminator)):
        raise NotImplementedError(
            "gradient_penalty_lambda > 0 is not supported with "
            "discriminator_type='linear'; use the conv discriminator or "
            "disable the gradient penalty")
    on = [f for f in IDENTIFICATION_FLAGS if getattr(hp, f)]
    roll_decode = (hp.adversarial_rollouts
                   or hp.style_reconstruction_weight > 0
                   or hp.diversity_weight > 0)
    if roll_decode and hp.quantized_inference:
        raise NotImplementedError(
            "adversarial_rollouts=True cannot train through "
            "quantized_inference=True (int8 rounding kills the rollout "
            "gradients); quantize for serving only")
    if on:
        raise NotImplementedError(
            f"{', '.join(on)}: adversarial rollouts and the identification "
            "machinery are not ported to gantron_tpu_torch yet (ROADMAP.md "
            "§1, item 8)")
    if hp.style_code_dims > generator.noise_size:
        raise ValueError(
            f"style_code_dims={hp.style_code_dims} exceeds noise_size="
            f"{generator.noise_size}: the code is a PREFIX of the style "
            "vector (config.py style_code_dims)")
    if hp.style_code_levels == 1:
        raise ValueError(
            "style_code_levels=1 is a constant code (nothing to identify); "
            "use 0 for continuous or >= 2 for a discrete grid")


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
    dtype = (torch.bfloat16 if hp.compute_dtype == "bfloat16" or hp.fp16_run
             else torch.float32)
    W = hp.discriminator_window

    def g_step(state, batch: Batch, g_lr, attn_weight, style=None):
        """One generator update of ``state`` (in place; returned). ``batch``
        holds tensors on the state's device. ``style``: optional
        (B, 1, noise_size) in place of the draw from the state's noise
        generator. Returns (state, metrics, (fake_mel, fake_lengths)): the
        teacher-forced postnet mel (float32, detached) and the batch's
        lengths, for the discriminator step."""
        G, D = state.g_model, state.d_model
        g_drop = state.dropout_generator
        out = _forward(G, dtype, batch.text, batch.text_lengths,
                       batch.mels.to(dtype), batch.speaker, batch.emotions,
                       batch.output_lengths, train=True, style=style,
                       generator=g_drop,
                       noise_generator=state.noise_generator)
        out = [o.float() for o in out]
        mel_l, gate_l, attn_l = tacotron2_loss(
            out, (batch.mels, batch.gate), batch.text_lengths,
            batch.output_lengths)
        taco = mel_l + gate_l
        adv = torch.zeros((), device=taco.device)
        if hp.d_freq > 0:
            adv = real * _adv_loss(D, pad_mel_to_window(out[1], W),
                                   batch.output_lengths, g_drop, dtype)
        total = taco + adv + attn_weight * attn_l
        params = list(G.parameters())
        grads = torch.autograd.grad(total, params)
        grad_norm = global_norm(grads)
        state.g_opt_state = g_tx.update(grads, state.g_opt_state, params,
                                        g_lr)
        state.step += 1
        metrics = dict(mel_loss=mel_l, gate_loss=gate_l,
                       attention_loss=attn_l, adversarial_loss=adv,
                       taco_loss=taco, generator_loss=total,
                       grad_norm=grad_norm)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, metrics, (out[1].detach(), batch.output_lengths)

    def d_step(state, real_mel, real_lengths, gen_mel, gen_lengths, d_lr):
        """One discriminator update of ``state`` (in place; returned) on real
        and generated (B, n_mel, T) mels. Returns (state, metrics)."""
        D = state.d_model
        d_drop = state.dropout_generator
        real_p = pad_mel_to_window(real_mel, W)
        gen_p = pad_mel_to_window(gen_mel.detach(), W)
        real_loss = real * _adv_loss(D, real_p, real_lengths, d_drop, dtype)
        fake_loss = fake * _adv_loss(D, gen_p, gen_lengths, d_drop, dtype)
        loss = (real_loss + fake_loss) / 2
        gp = torch.zeros((), device=loss.device)
        if hp.gradient_penalty_lambda > 0:
            def disc_scores(x):
                return D.scores(pad_mel_to_window(x, W).transpose(1, 2),
                                True, d_drop)

            gp = gradient_penalty(disc_scores, real_p, gen_p, real_lengths,
                                  gen_lengths, state.noise_generator)
            loss = loss + hp.gradient_penalty_lambda * gp
        params = list(D.parameters())
        grads = torch.autograd.grad(loss, params)
        grad_norm = global_norm(grads)
        state.d_opt_state = d_tx.update(grads, state.d_opt_state, params,
                                        d_lr)
        state.step += 1
        metrics = dict(discriminator_loss=loss, real_loss=real_loss,
                       fake_loss=fake_loss, gradient_penalty=gp,
                       discriminator_grad_norm=grad_norm)
        return state, {k: v.detach() for k, v in metrics.items()}

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
