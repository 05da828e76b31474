"""WaveGlow's inverse flow (NVIDIA/waveglow glow.py ``infer``), plain.

The mel is upsampled by a transposed conv (kernel ``upsample_kernel``,
stride ``upsample_stride``, the hop), cut to T * hop samples and grouped by
``n_group``; ``n_flows`` flows run in reverse: an affine coupling whose
WaveNet-like network (a 1x1 start conv, ``n_layers`` dilated gated layers of
kernel ``kernel_size`` conditioned on the grouped mel, res/skip 1x1 convs,
a 1x1 end conv) gives the shift b and log-scale s, audio_1 <- (audio_1 - b)
* exp(-s), then the inverse 1x1 conv; every ``n_early_every`` flows
``n_early_size`` channels of latent rejoin. ``c`` is a configuration's
``waveglow`` dict (NVIDIA's config.json: 12 flows, 8 groups, 8 layers of
256 channels, kernel 3, upsampler 1024 / 256).

Parameters are the dict the benchmark hands the program: torch conv
layouts, ``convinv_inv`` the inverse of each flow's 1x1 conv as the matrix
that right-multiplies an audio row (so W^-1 @ column is its transpose times
the column). ``z``: the unit-variance latents, the first (B, Tg, channels
of the last flow) and then one (B, Tg, n_early_size) for each early output,
scaled by sigma.
"""

import torch

from perfbench.reference.precision import Precision


def channels(c, k: int) -> int:
    """Audio channels that flow k sees."""
    return c["n_group"] - c["n_early_size"] * (k // c["n_early_every"])


def early(c, k: int) -> bool:
    return k % c["n_early_every"] == 0 and k > 0


def z_shapes(c, n_frames: int):
    Tg = n_frames * c["upsample_stride"] // c["n_group"]
    return [(Tg, channels(c, c["n_flows"] - 1))] + [
        (Tg, c["n_early_size"]) for k in reversed(range(c["n_flows"]))
        if early(c, k)]


def _wn(c, p, P_, audio_0, spect):
    n = c["n_channels"]
    x = P_.conv1d(audio_0, p["start_w"], p["start_b"])
    cond = P_.conv1d(spect, p["cond_w"], p["cond_b"])
    skip = 0.0
    for i in range(c["n_layers"]):
        d = 2 ** i
        a = P_.conv1d(x, p["in_w"][i], p["in_b"][i],
                      padding=d * (c["kernel_size"] - 1) // 2, dilation=d)
        cd = cond[:, 2 * n * i:2 * n * (i + 1)]
        acts = torch.tanh(a[:, :n] + cd[:, :n]) \
            * torch.sigmoid(a[:, n:] + cd[:, n:])
        rs = P_.conv1d(acts, p["res_skip_w"][i], p["res_skip_b"][i])
        if i < c["n_layers"] - 1:
            x = x + rs[:, :n]
            skip = skip + rs[:, n:]
        else:
            skip = skip + rs
    return P_.conv1d(skip, p["end_w"], p["end_b"])


@torch.no_grad()
def infer(c, params, mel, z, sigma, P_=Precision()):
    """(B, n_mel, T) float32 mel -> (B, T * hop) audio."""
    p = _as_float(params)
    B, M, T = mel.shape
    hop, G = c["upsample_stride"], c["n_group"]
    spect = P_.conv_transpose1d(mel, p["upsample_w"], p["upsample_b"],
                                stride=hop)[:, :, :T * hop]
    Tg = T * hop // G
    spect = spect.reshape(B, M, Tg, G).permute(0, 1, 3, 2) \
        .reshape(B, M * G, Tg)
    zs = iter(zi.float().transpose(1, 2) for zi in z)
    audio = sigma * next(zs)
    for k in reversed(range(c["n_flows"])):
        h = audio.shape[1] // 2
        out = _wn(c, p["wn"][k], P_, audio[:, :h], spect)
        audio = torch.cat([audio[:, :h], (audio[:, h:] - out[:, :h])
                           * torch.exp(-out[:, h:])], dim=1)
        audio = P_.mm(p["convinv_inv"][k].T, audio)
        if early(c, k):
            audio = torch.cat([sigma * next(zs), audio], dim=1)
    return audio.transpose(1, 2).reshape(B, -1)


def _as_float(tree):
    if isinstance(tree, dict):
        return {k: _as_float(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_float(v) for v in tree]
    return tree.float()
