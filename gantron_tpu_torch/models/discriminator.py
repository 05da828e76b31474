"""GAN discriminators over mel-spectrogram windows
(port of gantron_tpu/models/discriminator.py).

Both score fixed windows of ``discriminator_window`` mel frames. ``scores``
gives the window scores; ``forward`` is the Wasserstein-style adversarial
loss, the mean over samples of each sample's mean score over its valid
windows. Dropout 0.5 follows every hidden layer when ``train`` and the
``train_dropout`` switch are on, drawn from the ``torch.Generator`` passed in.
"""

import torch
from torch import nn

from gantron_tpu_torch.models.modules import ConvNorm, dropout, lecun_normal
from gantron_tpu_torch.utils.device import resolve_device


class Dense(nn.Module):
    """x @ w + b with w (in, out), lecun-normal init and a zero bias (flax
    ``nn.Dense``'s defaults)."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: torch.Generator = None):
        super().__init__()
        self.w = nn.Parameter(lecun_normal((in_dim, out_dim), generator))
        self.b = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x):
        return x @ self.w + self.b


class Discriminator(nn.Module):
    """Conv discriminator: the mel regrouped into windows, a dilated conv
    stack scoring each window."""

    def __init__(self, hp, generator: torch.Generator = None):
        super().__init__()
        self.hp = hp
        self.window = hp.discriminator_window
        self.in_dim = self.window * hp.n_mel_channels
        dim = hp.discriminator_dim
        first = min((self.in_dim // dim + 1) * dim, 1024)
        widths = [self.in_dim, first, dim, dim, hp.n_mel_channels]
        self.convs = nn.ModuleList(
            ConvNorm(widths[i], widths[i + 1], 5, dilation=dil, gain="tanh",
                     generator=generator)
            for i, dil in enumerate((1, 2, 2, 2)))
        self.out = nn.Conv1d(hp.n_mel_channels, 1, 1)
        with torch.no_grad():
            self.out.weight.copy_(lecun_normal((1, hp.n_mel_channels, 1),
                                               generator))
            self.out.bias.zero_()
        self.train_dropout = True

    def scores(self, mel, train: bool = True,
               generator: torch.Generator = None):
        """mel: (B, T, n_mel), T >= window -> (B, ceil(T / window)) scores.

        A T that is no multiple of the window gets an overlapping tail
        window (the last ``window`` frames) after the whole ones. The
        (B, T', n_mel) block is then reshaped row-major to
        (B, window * n_mel, T' / window), so channels interleave time and mel
        as in the reference; that is already Conv1d's (B, C, L) layout."""
        B, T, _ = mel.shape
        r = T % self.window
        if r:
            mel = torch.cat([mel[:, :T - r], mel[:, -self.window:]], dim=1)
        x = mel.reshape(B, self.in_dim, -1)
        for conv in self.convs:
            x = conv(x)
            if train and self.train_dropout:
                x = dropout(x, 0.5, generator)
            x = torch.tanh(x)
        return self.out(x)[:, 0]

    def forward(self, mel, target_length, train: bool = True,
                generator: torch.Generator = None):
        """Adversarial loss of (B, n_mel, T) mels: each sample's mean score
        over its ceil(length / window) valid windows, averaged."""
        scores = self.scores(mel.transpose(1, 2), train, generator)
        n_windows = scores.shape[1]
        n_valid = torch.clamp(torch.ceil(target_length / self.window).long(),
                              1, n_windows)
        valid = torch.arange(n_windows, device=mel.device)[None, :] \
            < n_valid[:, None]
        per_sample = torch.where(valid, scores, 0.0).sum(dim=1) / n_valid
        return per_sample.mean()


class LinearDiscriminator(nn.Module):
    """MLP discriminator over flattened windows that advance by
    ``window - U{0..max_window_overlap}`` frames."""

    def __init__(self, hp, generator: torch.Generator = None,
                 max_window_overlap: int = 6):
        super().__init__()
        self.hp = hp
        self.window = hp.discriminator_window
        self.max_window_overlap = max_window_overlap
        dim = hp.discriminator_dim
        widths = [self.window * hp.n_mel_channels, dim, dim, dim]
        self.dense = nn.ModuleList(Dense(widths[i], widths[i + 1], generator)
                                   for i in range(3))
        self.out = Dense(dim, 1, generator)
        self.train_dropout = True

    def scores(self, windows, train: bool = True,
               generator: torch.Generator = None):
        """windows: (..., window * n_mel) flattened mel windows -> (..., 1)."""
        x = windows
        for layer in self.dense:
            x = layer(x)
            if train and self.train_dropout:
                x = dropout(x, 0.5, generator)
            x = torch.tanh(x)
        return self.out(x)

    def forward(self, mel, target_length, train: bool = True,
                generator: torch.Generator = None, overlaps=None):
        """Adversarial loss of (B, n_mel, T) mels, T >= window: windows from
        frame 0 advancing by window - overlap, valid while they end before
        the sample's length, plus one tail window ending at the length.
        ``overlaps``: optional (B, >= max_windows) integer draws in
        [0, max_window_overlap], in place of draws from ``generator``."""
        W = self.window
        B, M, T = mel.shape
        device = mel.device
        x = mel.transpose(1, 2)  # (B, T, M)
        max_windows = max(T // (W - self.max_window_overlap) + 1, 1)
        if overlaps is None:
            overlaps = torch.randint(0, self.max_window_overlap + 1,
                                     (B, max_windows), generator=generator,
                                     device=device)
        else:
            overlaps = torch.as_tensor(overlaps, device=device).long()[
                :, :max_windows]
        strides = W - overlaps
        starts = torch.cat([torch.zeros((B, 1), dtype=torch.long,
                                        device=device),
                            torch.cumsum(strides[:, :-1], dim=1)], dim=1)
        valid = starts + W < target_length[:, None]
        starts = torch.clamp(starts, 0, T - W)
        span = torch.arange(W, device=device)
        idx = (starts[..., None] + span).reshape(B, -1)  # (B, n*W)
        win = torch.gather(x, 1, idx[..., None].expand(-1, -1, M))
        flat = win.reshape(B, max_windows, W * M)
        tail_start = torch.clamp(target_length.long() - W, 0, T - W)
        tail = torch.gather(
            x, 1, (tail_start[:, None] + span)[..., None].expand(-1, -1, M))
        windows = torch.cat([flat, tail.reshape(B, 1, W * M)], dim=1)
        scores = self.scores(windows, train, generator)[..., 0]
        valid = torch.cat([valid, torch.ones((B, 1), dtype=torch.bool,
                                             device=device)], dim=1)
        per_sample = (torch.where(valid, scores, 0.0).sum(dim=1)
                      / valid.sum(dim=1))
        return per_sample.mean()


def make_discriminator(hp, device="cuda", seed: int = 1):
    """The discriminator that ``hp.discriminator_type`` names, weights drawn
    from ``seed`` on the CPU and moved to ``device``."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    cls = (LinearDiscriminator if hp.discriminator_type == "linear"
           else Discriminator)
    return cls(hp, g).to(device)
