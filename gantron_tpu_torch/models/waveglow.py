"""WaveGlow vocoder (port of gantron_tpu/models/waveglow.py).

The inverse affine-coupling flow turns a (B, n_mel, T) log-mel into a
(B, T * hop) waveform; ``forward`` runs the flow the other way, audio to
latents. Parameters are a dict of tensors in torch's conv layout
(Cout, Cin, k), the layout of NVIDIA's WaveGlow checkpoints:
``{"upsample_w" (n_mel, n_mel, k), "upsample_b", "convinv_inv": [W^-T per
flow], "wn": [per-flow dicts]}``. Latents ``z`` keep the JAX package's
(B, Tg, channels) layout at the public functions. ``load_waveglow`` reads an
NVIDIA WaveGlow checkpoint (its weight-normed convs folded by
``convert_torch_state_dict``).
"""

from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from gantron_tpu_torch.utils.device import draw, resolve_device
from gantron_tpu_torch.utils.profiling import span, spanned


@dataclass(frozen=True)
class WaveGlowConfig:
    n_mel_channels: int = 80
    n_flows: int = 12
    n_group: int = 8
    n_early_every: int = 4
    n_early_size: int = 2
    n_layers: int = 8
    n_channels: int = 256
    kernel_size: int = 3
    upsample_kernel: int = 1024
    upsample_stride: int = 256

    def remaining_channels(self, k: int) -> int:
        """Audio channels entering flow k (forward direction)."""
        c = self.n_group
        for i in range(k + 1):
            if i % self.n_early_every == 0 and i > 0:
                c -= self.n_early_size
        return c


def _conv1d(x, w, b=None, dilation=1):
    """x: (B, Cin, T); w: (Cout, Cin, k); "same" padding."""
    return F.conv1d(x, w, b, padding=dilation * (w.shape[2] - 1) // 2,
                    dilation=dilation)


def _conv_transpose1d(x, w, b, stride):
    """torch ConvTranspose1d on channel-last x (B, T, Cin) -> (B, L, Cout),
    w (Cin, Cout, k). When the stride divides k (the upsampler: k 1024,
    stride 256) it is one (B*T, Cin) @ (Cin, k*Cout) product and k/stride
    shifted adds, with no work spent on the stride's inserted zeros."""
    Cin, Cout, k = w.shape
    if k % stride:
        out = F.conv_transpose1d(x.transpose(1, 2), w, stride=stride)
        return out.transpose(1, 2) + b
    B, T, _ = x.shape
    chunks = k // stride
    # y[b, t, c, s, o] = x[b, t] . w[:, o, c*stride + s]
    w_r = w.permute(2, 1, 0).reshape(chunks, stride, Cout, Cin)
    y = torch.einsum("bti,csoi->btcso", x, w_r)
    out = x.new_zeros(B, T + chunks - 1, stride, Cout)
    for c in range(chunks):
        out[:, c:c + T] += y[:, :, c]
    # (T + chunks - 1) * stride == (T - 1) * stride + k: the exact length.
    return out.reshape(B, (T + chunks - 1) * stride, Cout) + b


def _wn_forward(p: Dict, audio_0, spect, cfg: WaveGlowConfig):
    """WaveNet-like coupling network. audio_0: (B, n_half, Tg); spect:
    (B, n_mel*n_group, Tg). Returns (B, 2*n_half, Tg) = [b; s]."""
    n = cfg.n_channels
    x = _conv1d(audio_0, p["start_w"], p["start_b"])
    cond_all = _conv1d(spect, p["cond_w"], p["cond_b"])
    skip = 0.0
    for i in range(cfg.n_layers):
        acts = _conv1d(x, p["in_w"][i], p["in_b"][i], dilation=2 ** i)
        cond = cond_all[:, 2 * n * i: 2 * n * (i + 1)]
        acts = (torch.tanh(acts[:, :n] + cond[:, :n])
                * torch.sigmoid(acts[:, n:] + cond[:, n:]))
        res_skip = _conv1d(acts, p["res_skip_w"][i], p["res_skip_b"][i])
        if i < cfg.n_layers - 1:
            x = x + res_skip[:, :n]
            skip = skip + res_skip[:, n:]
        else:
            skip = skip + res_skip
    return _conv1d(skip, p["end_w"], p["end_b"])


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


class WaveGlow:
    """The inverse flow (``infer``) and its training direction
    (``forward``) on ``device``. ``dtype=torch.bfloat16`` keeps the weights
    and runs the flow in bfloat16 (the reference's ``.half()`` WaveGlow,
    as ``rtf.py`` runs it), with the audio returned in float32."""

    def __init__(self, config: WaveGlowConfig, params, device="cuda",
                 dtype=None):
        self.cfg = config
        self.device = resolve_device(device)
        self.dtype = dtype or torch.float32
        self.params = _map(
            lambda t: torch.as_tensor(t, dtype=torch.float32).to(
                self.device, self.dtype),
            params)

    def n_groups(self, n_mel_frames: int) -> int:
        """Grouped time steps Tg for a T-frame mel (after the upsample trim)."""
        cfg = self.cfg
        L = (n_mel_frames - 1) * cfg.upsample_stride + cfg.upsample_kernel
        L -= cfg.upsample_kernel - cfg.upsample_stride
        return L // cfg.n_group

    def z_shapes(self, n_mel_frames: int):
        """Latent shapes in consumption order: [init, early@k for k in
        reversed flows where k % n_early_every == 0 and k > 0]."""
        cfg = self.cfg
        Tg = self.n_groups(n_mel_frames)
        shapes = [(Tg, cfg.remaining_channels(cfg.n_flows - 1))]
        for k in reversed(range(cfg.n_flows)):
            if k % cfg.n_early_every == 0 and k > 0:
                shapes.append((Tg, cfg.n_early_size))
        return shapes

    def draw_z(self, generator, batch, n_mel_frames):
        return [draw(torch.randn, (batch,) + shape, generator,
                     device=self.device)
                for shape in self.z_shapes(n_mel_frames)]

    @spanned("vocoder.upsample")
    def _spect_features(self, mel):
        """Upsampled, grouped conditioning: (B, n_mel*n_group, Tg), features
        ordered mel-major as torch's unfold + permute give them."""
        cfg, p = self.cfg, self.params
        B = mel.shape[0]
        spect = _conv_transpose1d(mel.transpose(1, 2), p["upsample_w"],
                                  p["upsample_b"], cfg.upsample_stride)
        spect = spect[:, : spect.shape[1] - (cfg.upsample_kernel
                                              - cfg.upsample_stride)]
        Tg = spect.shape[1] // cfg.n_group
        spect = spect[:, : Tg * cfg.n_group].reshape(
            B, Tg, cfg.n_group, cfg.n_mel_channels)
        return spect.permute(0, 3, 2, 1).reshape(
            B, cfg.n_mel_channels * cfg.n_group, Tg)

    @torch.no_grad()
    @spanned("vocoder.infer")
    def infer(self, mel, sigma=0.666, generator=None, z=None):
        """mel: (B, n_mel, T) log-mel -> audio (B, T*hop) float32.

        ``z``: optional unit-variance latents of ``z_shapes`` (scaled by
        ``sigma`` here); drawn from ``generator`` when None."""
        cfg, p = self.cfg, self.params
        mel = torch.as_tensor(mel).to(self.device, self.dtype)
        B = mel.shape[0]
        if z is None:
            z = self.draw_z(generator, B, mel.shape[2])
        z = iter([torch.as_tensor(zi).to(self.device, self.dtype)
                  .transpose(1, 2) for zi in z])
        spect = self._spect_features(mel)

        audio = sigma * next(z)  # (B, C, Tg)
        with span("vocoder.flows"):
            for k in reversed(range(cfg.n_flows)):
                n_half = audio.shape[1] // 2
                audio_0, audio_1 = audio[:, :n_half], audio[:, n_half:]
                output = _wn_forward(p["wn"][k], audio_0, spect, cfg)
                b, s = output[:, :n_half], output[:, n_half:]
                audio = torch.cat([audio_0, (audio_1 - b) * torch.exp(-s)],
                                  dim=1)
                # Inverse 1x1 conv: audio_row @ W^-T, on channel-first audio.
                audio = p["convinv_inv"][k].T @ audio
                if k % cfg.n_early_every == 0 and k > 0:
                    audio = torch.cat([sigma * next(z), audio], dim=1)
        return audio.transpose(1, 2).reshape(B, -1).float()

    @torch.no_grad()
    def forward(self, audio, mel):
        """The training direction (audio -> latents), the exact inverse of
        ``infer``. audio: (B, samples); mel: (B, n_mel, T). Returns the
        latents of ``z_shapes`` in its consumption order, in the (B, Tg,
        channels) layout and at unit sigma: ``infer(mel, sigma=1.0,
        z=forward(audio, mel))`` gives the audio back."""
        cfg, p = self.cfg, self.params
        mel = torch.as_tensor(mel).to(self.device, self.dtype)
        audio = torch.as_tensor(audio).to(self.device, self.dtype)
        B = audio.shape[0]
        spect = self._spect_features(mel)
        Tg = spect.shape[2]
        x = audio[:, :Tg * cfg.n_group].reshape(B, Tg, cfg.n_group) \
            .transpose(1, 2)  # (B, C, Tg)
        early = []
        for k in range(cfg.n_flows):
            if k % cfg.n_early_every == 0 and k > 0:
                early.append(x[:, :cfg.n_early_size])
                x = x[:, cfg.n_early_size:]
            # Forward 1x1 conv: undo the stored inverse, row @ W == W^T @ col.
            W = torch.linalg.inv(p["convinv_inv"][k].double()).to(x.dtype)
            x = W.T @ x
            n_half = x.shape[1] // 2
            x0, x1 = x[:, :n_half], x[:, n_half:]
            output = _wn_forward(p["wn"][k], x0, spect, cfg)
            b, s = output[:, :n_half], output[:, n_half:]
            x = torch.cat([x0, x1 * torch.exp(s) + b], dim=1)
        return [z.transpose(1, 2).float() for z in [x] + early[::-1]]


def _fold_weight_norm(v, g):
    """weight = g * v / ||v|| with the norm over all but the out-channel dim
    (torch weight_norm dim=0 on (Cout, Cin, k))."""
    norm = torch.sqrt((v ** 2).sum(dim=(1, 2), keepdim=True))
    return g.reshape(-1, 1, 1) * v / norm


def convert_torch_state_dict(state_dict, cfg: WaveGlowConfig = WaveGlowConfig()):
    """An NVIDIA WaveGlow state_dict (tensors or arrays) as ``WaveGlow``
    params, in torch's layouts (port of the JAX package's converter).

    Accepts keys like 'upsample.weight', 'WN.0.in_layers.0.weight_v/g',
    'convinv.0.conv.weight'. Handles both the fused 'WN.k.cond_layer.*' and
    legacy per-layer 'WN.k.cond_layers.i.*' conditioning layouts. A conv
    without a bias gets a zero one.
    """
    sd = {k: torch.as_tensor(v).detach().to("cpu", torch.float64)
          for k, v in state_dict.items()}

    def wn_conv(prefix):
        if prefix + ".weight_v" in sd:
            w = _fold_weight_norm(sd[prefix + ".weight_v"],
                                  sd[prefix + ".weight_g"].reshape(-1))
        else:
            w = sd[prefix + ".weight"]
        b = sd.get(prefix + ".bias")
        return w, (b if b is not None else w.new_zeros(w.shape[0]))

    # ConvTranspose1d's (Cin, Cout, k) is the layout infer() takes.
    params = {"upsample_w": sd["upsample.weight"],
              "upsample_b": sd["upsample.bias"],
              "convinv_inv": [], "wn": []}
    for k in range(cfg.n_flows):
        W = sd[f"convinv.{k}.conv.weight"][:, :, 0]  # (C, C)
        # Right-multiply convention: audio_row @ (W^{-1})^T == W^{-1} @ col.
        params["convinv_inv"].append(torch.linalg.inv(W).T)

        wn = {}
        wn["start_w"], wn["start_b"] = wn_conv(f"WN.{k}.start")
        wn["end_w"], wn["end_b"] = wn_conv(f"WN.{k}.end")
        if f"WN.{k}.cond_layer.weight_v" in sd or \
                f"WN.{k}.cond_layer.weight" in sd:
            wn["cond_w"], wn["cond_b"] = wn_conv(f"WN.{k}.cond_layer")
        else:  # legacy per-layer conditioning -> concatenate along Cout
            pairs = [wn_conv(f"WN.{k}.cond_layers.{i}")
                     for i in range(cfg.n_layers)]
            wn["cond_w"] = torch.cat([w for w, _ in pairs], dim=0)
            wn["cond_b"] = torch.cat([b for _, b in pairs], dim=0)
        for name in ("in", "res_skip"):
            pairs = [wn_conv(f"WN.{k}.{name}_layers.{i}")
                     for i in range(cfg.n_layers)]
            wn[f"{name}_w"] = [w for w, _ in pairs]
            wn[f"{name}_b"] = [b for _, b in pairs]
        params["wn"].append(wn)
    return _map(lambda t: t.float(), params)


def load_waveglow(checkpoint_path, cfg: WaveGlowConfig = WaveGlowConfig(),
                  device="cuda", dtype=None) -> WaveGlow:
    """A WaveGlow on ``device`` from a torch checkpoint: NVIDIA's payload,
    whose ``"model"`` is the pickled module (unpickling it needs NVIDIA's
    ``glow`` module on the path), a payload whose ``"model"`` is a
    state_dict, or a bare state_dict. Full unpickling: load only trusted
    files."""
    payload = torch.load(checkpoint_path, map_location="cpu",
                         weights_only=False)
    model = payload.get("model", payload) if isinstance(payload, dict) \
        else payload
    sd = model.state_dict() if hasattr(model, "state_dict") else model
    return WaveGlow(cfg, convert_torch_state_dict(sd, cfg), device=device,
                    dtype=dtype)


def random_params(generator: torch.Generator, cfg: WaveGlowConfig):
    """Random (untrained) params with the right shapes, drawn on the CPU with
    the distributions of the JAX package's ``random_params``: N(0, 0.02^2)
    weights, zero end layers, a random orthogonal 1x1 conv per flow."""

    def nxt(*s):
        return 0.02 * torch.randn(s, generator=generator)

    M, n, L = cfg.n_mel_channels, cfg.n_channels, cfg.n_layers
    D = M * cfg.n_group
    params = {"upsample_w": nxt(M, M, cfg.upsample_kernel),
              "upsample_b": nxt(M), "convinv_inv": [], "wn": []}
    for k in range(cfg.n_flows):
        c = cfg.remaining_channels(k)
        q, _ = torch.linalg.qr(torch.randn((c, c), generator=generator))
        params["convinv_inv"].append(torch.linalg.inv(q).T.contiguous())
        n_half = c // 2
        params["wn"].append({
            "start_w": nxt(n, n_half, 1), "start_b": nxt(n),
            "end_w": torch.zeros(2 * n_half, n, 1),
            "end_b": torch.zeros(2 * n_half),
            "cond_w": nxt(2 * n * L, D, 1), "cond_b": nxt(2 * n * L),
            "in_w": [nxt(2 * n, n, cfg.kernel_size) for _ in range(L)],
            "in_b": [nxt(2 * n) for _ in range(L)],
            "res_skip_w": [nxt(2 * n if i < L - 1 else n, n, 1)
                           for i in range(L)],
            "res_skip_b": [nxt(2 * n if i < L - 1 else n) for i in range(L)],
        })
    return params
