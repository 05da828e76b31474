"""GANtron's conv discriminator and the Wasserstein losses, plain.

The mel (B, n_mel, T) is cut into windows of ``discriminator_window``
frames (T a multiple of the window here), each window read row-major as
one (window * n_mel)-channel column; four 1-D convs of kernel 5 (dilations
1, 2, 2, 2; widths min((in // dim + 1) * dim, 1024), dim, dim, n_mel), each
followed by dropout 0.5 in training and tanh, and a 1x1 conv give one
score a window. A sample's score is the mean over its ceil(length /
window) valid windows; the loss is the mean over samples.
"""

import torch

from perfbench.reference.precision import Precision
from perfbench.reference.tacotron2 import dropout


def param_shapes(m) -> dict:
    w, dim, M = m["discriminator_window"], m["discriminator_dim"], \
        m["n_mel_channels"]
    first = min((w * M // dim + 1) * dim, 1024)
    widths = [w * M, first, dim, dim, M]
    s = {}
    for i in range(4):
        s[f"convs.{i}.conv.weight"] = (widths[i + 1], widths[i], 5)
        s[f"convs.{i}.conv.bias"] = (widths[i + 1],)
    s["out.weight"] = (1, M, 1)
    s["out.bias"] = (1,)
    return s


def loss(Wd, m, mel, lengths, gen, train=True, P_=Precision()):
    """The adversarial loss of (B, n_mel, T) mels: the mean over samples of
    each sample's mean window score."""
    w = m["discriminator_window"]
    B, M, T = mel.shape
    if T % w:
        raise ValueError("the reference scores whole windows only")
    x = mel.transpose(1, 2).reshape(B, w * M, T // w)
    for i, dil in enumerate((1, 2, 2, 2)):
        x = P_.conv1d(x, Wd[f"convs.{i}.conv.weight"],
                      Wd[f"convs.{i}.conv.bias"], padding=2 * dil,
                      dilation=dil)
        if train:
            x = dropout(x, 0.5, gen)
        x = torch.tanh(x)
    scores = P_.conv1d(x, Wd["out.weight"], Wd["out.bias"])[:, 0]
    n = scores.shape[1]
    n_valid = torch.clamp(torch.ceil(lengths / w).long(), 1, n)
    valid = torch.arange(n, device=mel.device)[None, :] < n_valid[:, None]
    return (torch.where(valid, scores, 0.0).sum(dim=1) / n_valid).mean()
