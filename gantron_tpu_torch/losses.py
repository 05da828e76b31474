"""Loss functions (port of gantron_tpu/losses.py).

  * mel and gate losses are plain means over the padded tensors: the
    generator masks padded mel frames to 0 and padded gate energies to 1e3,
    so padding adds ~nothing to the numerator but counts in the denominator;
  * the attention guide is a per-sample masked BCE against a diagonal
    Gaussian, over the whole batch at once;
  * the gradient penalty differentiates the discriminator's summed scores
    with ``torch.autograd.grad(create_graph=True)``, so the D step's backward
    runs through that gradient (double backward).

Data parallel: each rank's rows are an equal share of one padded global
batch (parallel/mesh.py), so every mean here (the mel and gate MSE/BCE,
the attention guide's per-sample terms, the discriminator's per-sample
window means, the penalty's per-sample norms) has the same denominator on
every rank, and the global batch's loss is the mean of the ranks' losses.
"""

import torch


def mse(a, b):
    return torch.mean((a - b) ** 2)


def bce_with_logits(logits, targets):
    return torch.mean(torch.clamp(logits, min=0) - logits * targets
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def tacotron2_loss(model_output, targets, input_lengths, output_lengths):
    """(mel_loss, gate_loss, attention_loss) of the teacher-forced outputs
    [mel, mel_postnet, gate, alignments] against (mel_target, gate_target).
    With K frames a step the alignments have T_out / K rows, and the
    attention guide runs in step units: lengths ceil(output_length / K)."""
    mel_target, gate_target = targets
    mel_out, mel_out_postnet, gate_out, alignments = model_output
    mel_loss = mse(mel_out, mel_target) + mse(mel_out_postnet, mel_target)
    gate_loss = bce_with_logits(gate_out, gate_target)
    steps, T = alignments.shape[1], mel_target.shape[2]
    dec_lengths = output_lengths
    if steps != T:
        k = T // steps
        dec_lengths = torch.div(output_lengths + k - 1, k,
                                rounding_mode="floor")
    return mel_loss, gate_loss, attention_loss(alignments, input_lengths,
                                               dec_lengths)


def attention_loss(attention_weights, encoded_lengths, decoded_lengths):
    """Diagonal-Gaussian attention guide over (B, T_out, T_in) alignments.
    The target for input symbol n is a Gaussian (width 0.5 * sigma 3) at
    frame ``n * (dec_len - 1) // (enc_len - 1)``, integer division as in the
    reference; the per-element BCE is clamped at 100 as
    ``torch.binary_cross_entropy`` does."""
    B, T_out, T_in = attention_weights.shape
    device = attention_weights.device
    att = attention_weights.transpose(1, 2)  # (B, T_in, T_out)
    n = torch.arange(T_in, device=device)[None, :, None]
    t = torch.arange(T_out, device=device)[None, None, :]
    enc = encoded_lengths.long()[:, None, None]
    dec = decoded_lengths.long()[:, None, None]
    centers = torch.div(n * (dec - 1), torch.clamp(enc - 1, min=1),
                        rounding_mode="floor")
    target = torch.exp(-((t.float() - centers.float()) ** 2) / (0.5 * 3.0))
    valid = (n < enc) & (t < dec)
    eps = 1e-12
    att_c = torch.clamp(att, eps, 1.0 - eps)
    bce = -(target * torch.log(att_c) + (1.0 - target) * torch.log1p(-att_c))
    bce = torch.where(valid, torch.clamp(bce, max=100.0), 0.0)
    denom = (encoded_lengths * decoded_lengths).float()
    return torch.mean(bce.sum(dim=(1, 2)) / torch.clamp(denom, min=1.0))


def interpolation_weights(B, generator, device):
    """The penalty's per-sample mixing weights alpha ~ U[0, 1), (B, 1, 1)."""
    return torch.rand((B, 1, 1), generator=generator, device=device)


def gradient_penalty(disc_scores, real, generated, real_lengths,
                     generated_lengths, generator=None):
    """WGAN-GP on length-masked interpolates of (B, n_mel, T) mels, both cut
    to the shorter T. ``disc_scores(x)`` returns the discriminator's window
    scores; the penalty is mean((|d sum(scores) / d x| - 1)^2) over samples,
    with the gradient kept in the graph. Beyond the shorter of each pair's
    valid lengths the interpolate and its gradient are zero."""
    B = real.shape[0]
    T = min(real.shape[2], generated.shape[2])
    real_t, gen_t = real[:, :, :T], generated[:, :, :T]
    lengths = torch.clamp(torch.minimum(real_lengths, generated_lengths),
                          max=T)
    alpha = interpolation_weights(B, generator, real.device)
    interp = alpha * real_t + (1 - alpha) * gen_t
    mask = torch.arange(T, device=real.device)[None, None, :] \
        < lengths[:, None, None]
    interp = torch.where(mask, interp, 0.0)
    if not interp.requires_grad:
        interp.requires_grad_(True)
    grads, = torch.autograd.grad(disc_scores(interp).sum(), interp,
                                 create_graph=True)
    grads = torch.where(mask, grads, 0.0).reshape(B, -1)
    norms = torch.sqrt(torch.sum(grads ** 2, dim=1) + 1e-12)
    return torch.mean((norms - 1.0) ** 2)
