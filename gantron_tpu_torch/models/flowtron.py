"""Flowtron (Valle et al., arXiv:2005.05957; NVIDIA/flowtron ``flowtron.py``):
an autoregressive flow from mel frames to a Gaussian latent, conditioned on
the text through additive attention.

  text ids -> embedding -> Encoder (Tacotron 2's, ``models/tacotron2.py``)
  -> memory [encoder outputs ; speaker embedding] (B, T_in, 640)
  mel (B, n_mel, T) -> flow 0 -> flow 1 -> ... -> z (B, n_mel, T)

The encoder departs from the source's in its norm: Tacotron 2's BatchNorm,
over the whole padded batch in training and with running statistics at
inference, where the source passes InstanceNorm1d and runs the convs one
sequence at a time, cut to its length.

Each flow (``FlowStep``) maps the frames x to ``exp(log s) * x + b``, where
``log s`` and ``b`` at frame t depend only on the frames before it and on
the text: the frames shifted one step later (``[0; x_0 .. x_{T-2}]``) run
through the attention LSTM (80 -> 1024) to a; additive attention over the
memory, ``q = a W_q``, ``K = M W_k``, ``V = M W_v`` (no biases), scores
``v . tanh(q_t + K_j)`` with -inf past the text, softmax over the
characters, context ``c = weights V``; the last flow's gate ``[a ; c] W_g +
b_g``; a two-layer LSTM over ``[a ; c]`` (1664 -> 1024 -> 1024); two tanh
dense layers; and a kernel-1 conv (1024 -> 160) that gives ``[log s ; b]``.
Every other flow (the second, the fourth, ...) runs over each sequence
reversed in time with its padding kept at the end (``reverse_by_length``)
and reverses its output back; its ``log s`` and gate stay in the reversed
order, as the source returns them (the loss masks them by length, which
reads the same in either order, valid frames first).

Training (``forward``) transforms every frame at once: the LSTMs run whole
length-packed sequences (``ops/rnn.py::lstm_stack``) and the attention
scores the whole (frames x characters) grid in one call
(``ops/attention.py``). Inference (``infer``) inverts the flows in reverse
order one frame at a time, ``x_t = (z_t - b_t) / exp(log s_t)``; it runs
every sequence for the latent's T frames (the source's batch of one stops
at the gate; here the caller sets the length).

Matrices that activations multiply from the right are (in, out); LSTMs keep
``LSTMParams``' layout. Outputs are channel-first like the mel: z and each
``log s`` (B, n_mel, T), the gate (B, T), each flow's attention weights
(B, T, T_in).
"""

import math

import torch
from torch import nn

from gantron_tpu_torch.models.modules import xavier_uniform
from gantron_tpu_torch.models.tacotron2 import Encoder, get_mask_from_lengths
from gantron_tpu_torch.ops.attention import additive_attention
from gantron_tpu_torch.ops.rnn import LSTMParams, lstm_cell, lstm_stack
from gantron_tpu_torch.utils.device import resolve_device
from gantron_tpu_torch.utils.profiling import span, spanned


def reverse_by_length(x, lengths):
    """(B, T, C) -> each sequence's first ``lengths[b]`` frames reversed in
    time, then its padding, reversed too: the source's flip in time followed
    by a roll of each sequence by its length. The permutation is its own
    inverse, so the same call undoes it."""
    B, T, C = x.shape
    t = torch.arange(T, device=x.device)[None, :]
    n = lengths.to(x.device)[:, None]
    idx = torch.where(t < n, n - 1 - t, T - 1 + n - t)
    return torch.gather(x, 1, idx[..., None].expand(B, T, C))


def _bias(n_in, n_out, generator):
    """torch ``nn.Linear``'s default bias, U(-1/sqrt(in), 1/sqrt(in))."""
    return (torch.rand(n_out, generator=generator) * 2 - 1) / math.sqrt(n_in)


class FlowStep(nn.Module):
    """One affine autoregressive flow (the source's ``AR_Step``); frames
    (B, T, n_mel) in and out. ``gate``: whether this flow has the gate
    layer (the last flow does)."""

    def __init__(self, cfg, gate: bool, generator: torch.Generator = None):
        super().__init__()
        M, H, A = cfg.n_mel_channels, cfg.n_hidden, cfg.n_attn_channels
        D = cfg.n_text_dim + cfg.n_speaker_dim
        g, param = generator, nn.Parameter
        self.attention_lstm = LSTMParams(M, H, g)
        self.lstm = nn.ModuleList(
            LSTMParams(H + A if i == 0 else H, H, g)
            for i in range(cfg.n_lstm_layers))
        self.query_w = param(xavier_uniform((H, A), "tanh", g))
        self.key_w = param(xavier_uniform((D, A), "tanh", g))
        self.value_w = param(xavier_uniform((D, A), "tanh", g))
        self.v_w = param(xavier_uniform((A, 1), "linear", g))
        self.dense_w0 = param(xavier_uniform((H, H), "linear", g))
        self.dense_b0 = param(_bias(H, H, g))
        self.dense_w1 = param(xavier_uniform((H, H), "linear", g))
        self.dense_b1 = param(_bias(H, H, g))
        # The source starts every flow at the identity: its last conv zero.
        self.conv_w = param(torch.zeros(H, 2 * M))
        self.conv_b = param(torch.zeros(2 * M))
        self.has_gate = gate
        if gate:
            self.gate_w = param(xavier_uniform((H + A, 1), "sigmoid", g))
            self.gate_b = param(_bias(H + A, 1, g))

    def _readout(self, lstm_out):
        """[log s ; b] of the two-layer LSTM's output: two tanh dense layers
        and the kernel-1 conv."""
        u = torch.tanh(lstm_out @ self.dense_w0 + self.dense_b0)
        u = torch.tanh(u @ self.dense_w1 + self.dense_b1)
        return (u @ self.conv_w + self.conv_b).chunk(2, dim=-1)

    @spanned("flowtron.flow")
    def forward(self, x, memory, text_mask, lengths):
        """x (B, T, n_mel); memory (B, T_in, D); text_mask (B, T_in);
        ``lengths`` the frames of each sequence (on the host, for the
        LSTMs' packing). Returns (x', log s (B, T, n_mel), gate (B, T) or
        None, attention weights (B, T, T_in))."""
        x0 = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
        with span("flowtron.lstm"):
            a, _ = lstm_stack([self.attention_lstm], x0, lengths)
        with span("flowtron.attention"):
            c, weights = additive_attention(
                a @ self.query_w, memory @ self.key_w,
                memory @ self.value_w, self.v_w, text_mask)
        d = torch.cat([a, c], dim=-1)
        gate = (d @ self.gate_w + self.gate_b)[..., 0] if self.has_gate \
            else None
        with span("flowtron.lstm"):
            h, _ = lstm_stack(list(self.lstm), d, lengths)
        log_s, b = self._readout(h)
        return torch.exp(log_s) * x + b, log_s, gate, weights

    def infer(self, z, memory, text_mask):
        """The inverse, frame by frame: z (B, T, n_mel) -> x (B, T,
        n_mel), each frame from the frames inverted before it."""
        B, T, M = z.shape
        keys, values = memory @ self.key_w, memory @ self.value_w
        layers = [self.attention_lstm] + list(self.lstm)
        h = [z.new_zeros(B, p.w_hh.shape[0]) for p in layers]
        c = [torch.zeros_like(x) for x in h]
        prev, out = z.new_zeros(B, M), []
        for t in range(T):
            with span("flowtron.infer.step", events=False):
                h[0], c[0] = lstm_cell(layers[0], prev, h[0], c[0])
                ctx, _ = additive_attention(
                    (h[0] @ self.query_w)[:, None], keys, values, self.v_w,
                    text_mask)
                y = torch.cat([h[0], ctx[:, 0]], dim=-1)
                for i in range(1, len(layers)):
                    h[i], c[i] = lstm_cell(layers[i], y, h[i], c[i])
                    y = h[i]
                log_s, b = self._readout(y)
                prev = (z[:, t] - b) / torch.exp(log_s)
                out.append(prev)
        return torch.stack(out, dim=1)


class Flowtron(nn.Module):
    """Text and speaker -> memory -> ``cfg.n_flows`` flows (module
    docstring); ``cfg`` a ``config.FlowtronConfig``. Weights are drawn from
    ``seed`` on the host, then moved to ``device``."""

    def __init__(self, cfg, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.n_components or cfg.use_cumm_attention:
            raise NotImplementedError(
                "Flowtron here has the fixed Gaussian (n_components 0) and "
                "no cumulative attention")
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        # torch nn.Embedding's default, N(0, 1), as the source keeps it.
        self.embedding = nn.Parameter(
            torch.randn(cfg.n_text, cfg.n_text_dim, generator=g))
        self.speaker_embedding = nn.Parameter(
            torch.randn(cfg.n_speakers, cfg.n_speaker_dim, generator=g))
        self.encoder = Encoder(cfg, cfg.n_text_dim, g)
        self.flows = nn.ModuleList(
            FlowStep(cfg, cfg.use_gate_layer and k == cfg.n_flows - 1, g)
            for k in range(cfg.n_flows))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def memory(self, text, in_lens, speaker_ids, train=False,
               generator=None):
        """[Encoder(embedding[text]) ; the speaker's embedding at every
        character] (B, T_in, n_text_dim + n_speaker_dim). In training the
        encoder's convs see the padded batch (batch-statistics BatchNorm,
        dropout 0.5); otherwise they see zeros past each text."""
        mask = None if train else get_mask_from_lengths(in_lens,
                                                        text.shape[1])
        enc = self.encoder(self.embedding[text], in_lens, mask=mask,
                           train=train, generator=generator)
        spk = self.speaker_embedding[speaker_ids][:, None]
        return torch.cat([enc, spk.expand(-1, enc.shape[1], -1)], dim=-1)

    def forward(self, mel, speaker_ids, text, in_lens, out_lens,
                train: bool = False, generator: torch.Generator = None):
        """mel (B, n_mel, T), zero or not past each of ``out_lens``;
        ``train``: the encoder's training mode and its dropout, drawn from
        ``generator``. Returns (z (B, n_mel, T), [log s (B, n_mel, T) a
        flow], the last flow's gate logits (B, T) or None, [attention
        weights (B, T, T_in) a flow])."""
        lengths = out_lens.cpu()  # the LSTMs' packing, read once
        memory = self.memory(text, in_lens, speaker_ids, train, generator)
        text_mask = get_mask_from_lengths(in_lens, text.shape[1])
        x = mel.transpose(1, 2)
        log_s_all, attns, gate = [], [], None
        for k, flow in enumerate(self.flows):
            back = k % 2 == 1
            if back:
                x = reverse_by_length(x, out_lens)
            x, log_s, g, weights = flow(x, memory, text_mask, lengths)
            if back:
                x = reverse_by_length(x, out_lens)
            log_s_all.append(log_s.transpose(1, 2))
            attns.append(weights)
            gate = g if g is not None else gate
        return x.transpose(1, 2), log_s_all, gate, attns

    @torch.no_grad()
    def infer(self, residual, speaker_ids, text, in_lens=None,
              out_lens=None):
        """The mel (B, n_mel, T) whose latent is ``residual`` (B, n_mel, T;
        the caller scales it by sigma): the flows inverted in reverse order,
        each reversed flow inside its reversal by ``out_lens`` (all T by
        default), the encoder in inference mode. A sequence's valid frames
        depend on no frame past its length."""
        B, _, T = residual.shape
        dev = residual.device
        full = torch.full((B,), T, dtype=torch.long, device=dev)
        in_lens = (torch.full((B,), text.shape[1], dtype=torch.long,
                              device=dev) if in_lens is None else in_lens)
        out_lens = full if out_lens is None else out_lens
        with span("flowtron.infer"):
            memory = self.memory(text, in_lens, speaker_ids)
            text_mask = get_mask_from_lengths(in_lens, text.shape[1])
            x = residual.transpose(1, 2)
            for k in reversed(range(len(self.flows))):
                back = k % 2 == 1
                if back:
                    x = reverse_by_length(x, out_lens)
                x = self.flows[k].infer(x, memory, text_mask)
                if back:
                    x = reverse_by_length(x, out_lens)
        return x.transpose(1, 2)
