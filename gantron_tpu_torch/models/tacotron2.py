"""Tacotron2 generator (port of gantron_tpu/models/tacotron2.py).

  symbol embedding -> [optional emotion/noise channels] -> conv encoder ->
  BiLSTM -> [speaker/emotion/noise memory concat] -> decoder with
  location-sensitive attention -> postnet.

The decoder runs one Python-loop iteration per step, teacher-forced in
training (``Tacotron2.forward``), free-running at inference (``infer``,
and ``Decoder.infer_segment``, in segments, for streaming) and free-running
with autograd history in the G step's adversarial rollouts (``rollout``),
whose mel the InfoGAN ``StyleEncoder`` reads back (``predict_style``). With
``hp.quantized_inference`` the free-running decoder's four recurrence
matrices are int8 and every step sends them through the ``qmm`` kernel
(ops/quant.py): 4 launches a step. Training never quantizes. ``n_frames_per_step = K`` emits K mel frames a step.

Training-only dropouts (encoder, postnet, attention and decoder LSTMs) run
when ``train=True`` and the module's ``train_dropout`` switch is on; the
prenet's dropout runs in training and at inference unless ``prenet_dropout``
is off (``modules.disable_dropout`` turns both off). Every draw comes from
the ``torch.Generator`` passed in.

Public outputs keep the JAX package's layouts: mels (B, n_mel, T), gates
(B, T), alignments (B, steps, T_in).
"""

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from gantron_tpu_torch.models.modules import (BatchNorm, ConvNorm, dropout,
                                              lecun_normal, xavier_uniform)
from gantron_tpu_torch.ops.quant import (QuantizedMatrix, matmul_rhs,
                                         quantize_per_channel)
from gantron_tpu_torch.ops.rnn import LSTMParams, gates_to_state, masked_bilstm
from gantron_tpu_torch.utils.device import draw, resolve_device
from gantron_tpu_torch.utils.profiling import span, spanned

N_EMOTIONS = 5
N_SPEAKERS = 123


def get_mask_from_lengths(lengths, max_len):
    """(B,) -> (B, max_len) boolean validity mask."""
    return torch.arange(max_len, device=lengths.device)[None, :] \
        < lengths[:, None]


class ScanWeights(NamedTuple):
    """Weights read by every decoder step; the four big ones may be
    QuantizedMatrix."""

    wc: object                # attention_rnn.w_ih[prenet_dim:] (context rows)
    wh1: object               # attention_rnn.w_hh
    wq: torch.Tensor          # query_w
    v: torch.Tensor           # v_w
    loc_kernel: torch.Tensor  # merged location kernel, conv1d (att, 2, k)
    w2ih: object              # decoder_rnn.w_ih
    w2hh: object              # decoder_rnn.w_hh
    b2: torch.Tensor          # decoder_rnn.b


class Encoder(nn.Module):
    """Conv stack + BiLSTM over (B, T, in_dim) embeddings -> (B, T, E)."""

    def __init__(self, hp, in_dim: int, generator: torch.Generator = None):
        super().__init__()
        E, k = hp.encoder_embedding_dim, hp.encoder_kernel_size
        dims = [in_dim] + [E] * hp.encoder_n_convolutions
        self.convs = nn.ModuleList(
            ConvNorm(dims[i], E, k, gain="relu", generator=generator)
            for i in range(hp.encoder_n_convolutions))
        self.bns = nn.ModuleList(
            BatchNorm(E) for _ in range(hp.encoder_n_convolutions))
        self.lstm_fw = LSTMParams(E, E // 2, generator)
        self.lstm_bw = LSTMParams(E, E // 2, generator)
        self.train_dropout = True

    @spanned("encoder")
    def forward(self, x, input_lengths, mask=None, train: bool = False,
                generator: torch.Generator = None):
        """``mask``: optional (B, T) validity mask, applied before every conv
        so that a padded batch sees the zeros of "same" padding beyond each
        text, as the unpadded text would. Inference passes it; training
        does not (the convs and BatchNorm see the pad symbols, as in the
        reference). ``train``: batch-statistics BatchNorm and dropout 0.5
        after every conv."""
        x = x.transpose(1, 2)
        for conv, bn in zip(self.convs, self.bns):
            if mask is not None:
                x = x.masked_fill(~mask[:, None, :], 0.0)
            x = F.relu(bn(conv(x, train), train))
            if train and self.train_dropout:
                x = dropout(x, 0.5, generator)
        return masked_bilstm(self.lstm_fw, self.lstm_bw, x.transpose(1, 2),
                             input_lengths)


class Postnet(nn.Module):
    """Conv layers refining the mel: (B, n_mel, T) -> residual (B, n_mel, T)."""

    def __init__(self, hp, generator: torch.Generator = None):
        super().__init__()
        n, M = hp.postnet_n_convolutions, hp.n_mel_channels
        dims = [M] + [hp.postnet_embedding_dim] * (n - 1) + [M]
        self.convs = nn.ModuleList(
            ConvNorm(dims[i], dims[i + 1], hp.postnet_kernel_size,
                     gain="linear" if i == n - 1 else "tanh",
                     generator=generator)
            for i in range(n))
        self.bns = nn.ModuleList(BatchNorm(dims[i + 1]) for i in range(n))
        self.train_dropout = True

    @spanned("postnet")
    def forward(self, x, train: bool = False,
                generator: torch.Generator = None):
        n = len(self.convs)
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            x = bn(conv(x, train), train)
            if i < n - 1:
                x = torch.tanh(x)
            if train and self.train_dropout:
                x = dropout(x, 0.5, generator)
        return x


def _same_pad(x, kernel: int, stride: int):
    """Flax's "SAME" padding of a strided conv over (B, C, T): the output
    has ceil(T / stride) frames and the pad is split with the smaller half
    on the left (1/2 frames for an even T at kernel 5, stride 2; 2/2 for an
    odd T)."""
    T = x.shape[2]
    pad = max((-(-T // stride) - 1) * stride + kernel - T, 0)
    return F.pad(x, (pad // 2, pad - pad // 2))


class StyleEncoder(nn.Module):
    """InfoGAN identification head (the Q head): free-running mel (B, n_mel,
    T) and valid frame lengths (B,) -> predicted style code (B, out_dim) in
    (0, 1). Two strided convs, a mean over the valid (stride-4) frames and a
    dense layer; the sigmoid matches the uniform style prior. Its gradient
    reaches the generator through the differentiable rollout
    (``Decoder.rollout``). Kernels are drawn lecun-normal, biases zero, as
    Flax initializes them."""

    def __init__(self, hp, out_dim: int, generator: torch.Generator = None):
        super().__init__()
        M = hp.n_mel_channels
        D = max(M, 128)
        self.conv_0 = nn.Conv1d(M, D, 5, stride=2)
        self.conv_1 = nn.Conv1d(D, D, 5, stride=2)
        with torch.no_grad():
            for conv in (self.conv_0, self.conv_1):
                conv.weight.copy_(lecun_normal(tuple(conv.weight.shape),
                                               generator))
                conv.bias.zero_()
        self.out_w = nn.Parameter(lecun_normal((D, out_dim), generator))
        self.out_b = nn.Parameter(torch.zeros(out_dim))

    def forward(self, mel_bmt, lengths):
        x = F.relu(self.conv_0(_same_pad(mel_bmt, 5, 2)))
        x = F.relu(self.conv_1(_same_pad(x, 5, 2)))
        # Mean over the valid downsampled frames only: frames past each
        # rollout's gate stop are zero and must not dilute the statistic.
        valid = get_mask_from_lengths((lengths + 3) // 4, x.shape[2])
        denom = valid.sum(dim=1, keepdim=True).clamp(min=1)
        pooled = ((x * valid[:, None, :].to(x.dtype)).sum(dim=2)
                  / denom.to(x.dtype))
        return torch.sigmoid(pooled @ self.out_w + self.out_b)


class Decoder(nn.Module):
    """Mel decoder with location-sensitive attention: teacher-forced
    (``forward``), free-running (``infer``), free-running in segments
    (``infer_segment``) or free-running with autograd history
    (``rollout``)."""

    def __init__(self, hp, memory_dim: int, generator: torch.Generator = None):
        super().__init__()
        self.hp = hp
        self.memory_dim = D = memory_dim
        P, A, R, M = (hp.prenet_dim, hp.attention_rnn_dim, hp.decoder_rnn_dim,
                      hp.n_mel_channels)
        K = hp.n_frames_per_step
        att, F_, k = (hp.attention_dim, hp.attention_location_n_filters,
                      hp.attention_location_kernel_size)
        # The reference keeps prenet dropout on at inference; tests of the
        # deterministic math turn it off here.
        self.prenet_dropout = True
        self.train_dropout = True

        def xavier(shape, gain="linear"):
            return nn.Parameter(xavier_uniform(shape, gain, generator))

        self.prenet_w0 = xavier((M * K, P))
        self.prenet_w1 = xavier((P, P))
        self.attention_rnn = LSTMParams(P + D, A, generator)
        self.query_w = xavier((A, att), "tanh")
        self.memory_w = xavier((D, att), "tanh")
        self.v_w = xavier((att, 1))
        # (k, 2, filters), the JAX package's layout; drawn as a torch conv.
        self.loc_conv_w = nn.Parameter(
            xavier_uniform((F_, 2, k), "linear", generator).permute(2, 1, 0)
            .contiguous())
        self.loc_dense_w = xavier((F_, att), "tanh")
        self.decoder_rnn = LSTMParams(A + D, R, generator)
        self.proj_w = xavier((R + D, M * K))
        self.proj_b = nn.Parameter(torch.zeros(M * K))
        self.gate_w = xavier((R + D, 1), "sigmoid")
        self.gate_b = nn.Parameter(torch.zeros(1))

    # -- pieces -------------------------------------------------------------
    def _prenet(self, x, generator):
        x = F.relu(x @ self.prenet_w0)
        if self.prenet_dropout:
            x = dropout(x, 0.5, generator)
        x = F.relu(x @ self.prenet_w1)
        if self.prenet_dropout:
            x = dropout(x, 0.5, generator)
        return x

    def _merged_location_kernel(self):
        """location conv (k, 2, F) composed with location dense (F, att): one
        conv1d weight (att, 2, k), since both maps are linear."""
        merged = torch.einsum("kcf,fa->kca", self.loc_conv_w, self.loc_dense_w)
        return merged.permute(2, 1, 0).contiguous()

    def _scan_weights(self, quantize: bool = False,
                      stop_big: bool = False) -> ScanWeights:
        """The in-loop weights; ``quantize=True`` stores the four big
        recurrence matrices as per-channel int8 for the qmm kernel.
        ``stop_big=True`` detaches the five large ones (wc, wh1, wq, w2ih,
        w2hh) for the deferred-dW backward (``train/step.py``
        ``apply_deferred_dw`` rebuilds their gradients); the values are
        the same."""
        P = self.hp.prenet_dim
        sg = (lambda w: w.detach()) if stop_big else (lambda w: w)
        big = ((lambda w: quantize_per_channel(sg(w))) if quantize else sg)
        return ScanWeights(
            wc=big(self.attention_rnn.w_ih[P:]),
            wh1=big(self.attention_rnn.w_hh),
            wq=sg(self.query_w),
            v=self.v_w,
            loc_kernel=self._merged_location_kernel(),
            w2ih=big(self.decoder_rnn.w_ih),
            w2hh=big(self.decoder_rnn.w_hh),
            b2=self.decoder_rnn.b)

    def _location(self, attn_w, attn_w_cum, loc_kernel):
        cat = torch.stack([attn_w, attn_w_cum], dim=1)  # (B, 2, T_in)
        out = F.conv1d(cat, loc_kernel,
                       padding=self.hp.attention_location_kernel_size // 2)
        return out.transpose(1, 2)  # (B, T_in, att)

    def _attend(self, attn_h, memory, processed_memory, attn_w, attn_w_cum,
                mask, W: ScanWeights, zq=None):
        processed_query = attn_h @ W.wq
        if zq is not None:
            processed_query = processed_query + zq
        processed_query = processed_query[:, None]  # (B, 1, att)
        processed_loc = self._location(attn_w, attn_w_cum, W.loc_kernel)
        energies = (torch.tanh(processed_query + processed_loc
                               + processed_memory) @ W.v)[..., 0]
        if mask is not None:
            energies = energies.masked_fill(~mask, -math.inf)
        weights = torch.softmax(energies, dim=1)
        context = torch.bmm(weights[:, None], memory)[:, 0]
        return context, weights

    def _init_state(self, memory):
        B, T_in, _ = memory.shape
        hp = self.hp

        def z(*s):
            return memory.new_zeros(s)

        return (z(B, hp.attention_rnn_dim), z(B, hp.attention_rnn_dim),
                z(B, hp.decoder_rnn_dim), z(B, hp.decoder_rnn_dim),
                z(B, T_in), z(B, T_in), z(B, self.memory_dim))

    def _step_core(self, state, attn_in_proj, memory, processed_memory, mask,
                   W: ScanWeights, train: bool = False,
                   generator: torch.Generator = None, z1=None, z2=None,
                   zq=None):
        """One step of both LSTMs and the attention; ``attn_in_proj`` is
        prenet_t @ w_ih[:P] + b. ``train`` adds the attention and decoder
        dropouts (p_attention_dropout, p_decoder_dropout).

        ``z1``/``z2``/``zq``: optional zero-valued offsets added to the
        attention LSTM's gates, the decoder LSTM's gates and the processed
        query (the deferred-dW backward): adding a zero changes no value,
        and each offset's gradient is this step's gate gradient."""
        hp = self.hp
        drop = train and self.train_dropout
        attn_h, attn_c, dec_h, dec_c, attn_w, attn_w_cum, context = state
        gates = (attn_in_proj + matmul_rhs(context, W.wc)
                 + matmul_rhs(attn_h, W.wh1))
        if z1 is not None:
            gates = gates + z1
        attn_h, attn_c = gates_to_state(gates, attn_c)
        if drop and hp.p_attention_dropout > 0:
            attn_h = dropout(attn_h, hp.p_attention_dropout, generator)
        context, attn_w_new = self._attend(attn_h, memory, processed_memory,
                                           attn_w, attn_w_cum, mask, W, zq)
        attn_w_cum = attn_w_cum + attn_w_new
        dec_in = torch.cat([attn_h, context], dim=-1)
        gates2 = (matmul_rhs(dec_in, W.w2ih) + matmul_rhs(dec_h, W.w2hh)
                  + W.b2)
        if z2 is not None:
            gates2 = gates2 + z2
        dec_h, dec_c = gates_to_state(gates2, dec_c)
        if drop and hp.p_decoder_dropout > 0:
            dec_h = dropout(dec_h, hp.p_decoder_dropout, generator)
        return (attn_h, attn_c, dec_h, dec_c, attn_w_new, attn_w_cum, context)

    def forward(self, memory, mels, memory_lengths, train: bool = True,
                generator: torch.Generator = None, dw_offsets=None):
        """Teacher-forced pass. memory: (B, T_in, D); mels: (B, n_mel, T_out)
        ground truth, T_out a multiple of K; memory_lengths: (B,).

        The prenet and the attention LSTM's input projection run once over
        all steps before the loop, and the mel and gate projections once
        after it. Step t sees the go frame (t = 0) or ground-truth group
        t - 1. Returns (mel (B, n_mel, T_out), gate (B, T_out) with each
        step's energy repeated K times, alignments (B, T_out / K, T_in)).

        ``dw_offsets``: optional dict of zero-valued per-step offsets
        {"z1": (steps, B, 4 attention_rnn_dim), "z2": (steps, B,
        4 decoder_rnn_dim), "zq": (steps, B, attention_dim)} for the
        deferred-dW backward: the five big in-loop weights are detached,
        and a fourth value, ``dw_aux`` = {"attn_hs", "dec_hs", "contexts"}
        (each (steps, B, ·), detached), carries the per-step activations
        that rebuild their gradients after the loop."""
        hp = self.hp
        B, T_in, _ = memory.shape
        M, K, P = hp.n_mel_channels, hp.n_frames_per_step, hp.prenet_dim
        T_out = mels.shape[2]
        if T_out % K:
            raise ValueError(f"T_out {T_out} is not a multiple of "
                             f"n_frames_per_step {K}")
        steps = T_out // K
        mask = get_mask_from_lengths(memory_lengths, T_in)
        processed_memory = memory @ self.memory_w
        W = self._scan_weights(stop_big=dw_offsets is not None)

        groups = mels.transpose(1, 2).reshape(B, steps, K * M)
        frames = torch.cat([groups.new_zeros(B, 1, K * M), groups[:, :-1]],
                           dim=1).transpose(0, 1)  # (steps, B, K*M)
        prenet_out = self._prenet(frames, generator)
        attn_in_proj = (prenet_out @ self.attention_rnn.w_ih[:P]
                        + self.attention_rnn.b)  # (steps, B, 4A)

        # Per-step views by unbind: indexing z[t] would record one
        # select_backward a step, each a zero buffer of the whole offset.
        offsets = ([None] * steps,) * 3 if dw_offsets is None else tuple(
            dw_offsets[k].unbind(0) for k in ("z1", "z2", "zq"))
        state = self._init_state(memory)
        attn_hs, dec_hs, contexts, attn_ws = [], [], [], []
        with span("decoder.loop"):
            for t in range(steps):
                with span("decoder.step", events=False):
                    state = self._step_core(
                        state, attn_in_proj[t], memory, processed_memory,
                        mask, W, train, generator, *(z[t] for z in offsets))
                    attn_hs.append(state[0])
                    dec_hs.append(state[2])
                    contexts.append(state[6])
                    attn_ws.append(state[4])
        dec_hs, contexts = torch.stack(dec_hs), torch.stack(contexts)
        hidden_ctx = torch.cat([dec_hs, contexts], dim=-1)  # (steps, B, R+D)
        mel_out = hidden_ctx @ self.proj_w + self.proj_b
        gate_out = (hidden_ctx @ self.gate_w + self.gate_b)[..., 0]
        mel_bmt = mel_out.transpose(0, 1).reshape(B, T_out, M).transpose(1, 2)
        outs = (mel_bmt, gate_out.T.repeat_interleave(K, dim=1),
                torch.stack(attn_ws, dim=1))
        if dw_offsets is None:
            return outs
        dw_aux = dict(attn_hs=torch.stack(attn_hs).detach(),
                      dec_hs=dec_hs.detach(), contexts=contexts.detach())
        return outs + (dw_aux,)

    def _open_step(self, carry, generator, memory, processed_memory, W,
                   mask=None):
        """ONE free-running step. carry: (state, prev_frame, finished,
        length, t). Returns (next_carry, (mel_rec, gate_t, attn_w)): the
        un-zeroed ``mel_t`` is fed back as the next ``prev``, while
        ``mel_rec`` has frames past each sample's stop zeroed."""
        hp = self.hp
        P = hp.prenet_dim
        state, prev, finished, length, t = carry
        prenet_t = self._prenet(prev, generator)
        proj_t = prenet_t @ self.attention_rnn.w_ih[:P] + self.attention_rnn.b
        state = self._step_core(state, proj_t, memory, processed_memory, mask,
                                W)
        dec_h, context, attn_w = state[2], state[6], state[4]
        hidden_ctx = torch.cat([dec_h, context], dim=-1)
        mel_t = hidden_ctx @ self.proj_w + self.proj_b
        gate_t = (hidden_ctx @ self.gate_w + self.gate_b)[..., 0]

        stop_now = torch.sigmoid(gate_t) > hp.gate_threshold
        newly = stop_now & ~finished
        length = torch.where(newly, t + 1, length)
        mel_rec = torch.where(finished[:, None], 0.0, mel_t)
        finished = finished | stop_now
        return ((state, mel_t, finished, length, t + 1),
                (mel_rec, gate_t, attn_w))

    def open_loop_inputs(self, memory, memory_lengths=None, W=None):
        """What every free-running step reads besides its carry, computed
        once a decode: the processed memory, the scan weights (int8 with
        ``hp.quantized_inference``; ``W`` if given) and the attention mask
        (None unpadded)."""
        mask = (get_mask_from_lengths(memory_lengths, memory.shape[1])
                if memory_lengths is not None else None)
        if W is None:
            W = self._scan_weights(quantize=self.hp.quantized_inference)
        return memory @ self.memory_w, W, mask

    @torch.no_grad()
    def _decode(self, memory, generator, max_steps, memory_lengths,
                early_exit: bool):
        S = max_steps or self.hp.max_decoder_steps
        _, mel, gate, alignments, lengths, _ = self.infer_segment(
            memory, self.infer_init(memory, S), generator, S,
            self.open_loop_inputs(memory, memory_lengths), early_exit)
        return mel, gate, alignments, lengths

    def infer(self, memory, generator=None, max_steps: Optional[int] = None,
              memory_lengths=None):
        """Free-running decode of exactly S = max_steps steps (default
        hp.max_decoder_steps). ``memory_lengths``: optional (B,) valid lengths
        of a padded batch; attention is masked beyond them.

        Returns (mel (B, n_mel, S*K), gate (B, S*K), alignments (B, S, T_in),
        mel_lengths (B,)): a sample's length is K * the step at which its gate
        first fired, else S*K; its frames past that step are zero."""
        return self._decode(memory, generator, max_steps, memory_lengths,
                            early_exit=False)

    def infer_early_exit(self, memory, generator=None,
                         max_steps: Optional[int] = None,
                         memory_lengths=None):
        """Like ``infer``, but stops once every sample's gate has fired; the
        outputs keep S steps, zero after the last one run."""
        return self._decode(memory, generator, max_steps, memory_lengths,
                            early_exit=True)

    def rollout(self, memory, generator, n_steps: int, memory_lengths=None):
        """Free-running decode of exactly ``n_steps`` steps that records
        autograd history: the adversarial rollouts and identification terms
        of the G step differentiate through it into every weight, the
        in-loop LSTM and attention weights included. The steps are
        ``_open_step``'s, as in ``infer``, with float weights whatever
        ``hp.quantized_inference`` says (training refuses int8 rollouts) and
        no host sync; attention is masked beyond ``memory_lengths``. Returns
        what ``infer`` returns."""
        hp = self.hp
        B = memory.shape[0]
        K, M = hp.n_frames_per_step, hp.n_mel_channels
        processed_memory, W, mask = self.open_loop_inputs(
            memory, memory_lengths, self._scan_weights())
        carry = self.infer_init(memory, n_steps)
        mels, gates, attns = [], [], []
        for _ in range(n_steps):
            carry, (mel_t, gate_t, attn_t) = self._open_step(
                carry, generator, memory, processed_memory, W, mask)
            mels.append(mel_t)
            gates.append(gate_t)
            attns.append(attn_t)
        mel_bmt = torch.stack(mels, dim=1).reshape(B, n_steps * K, M) \
            .transpose(1, 2)
        return (mel_bmt, torch.stack(gates, dim=1).repeat_interleave(K, dim=1),
                torch.stack(attns, dim=1), carry[3] * K)

    @torch.no_grad()
    def infer_loop(self, memory, max_steps: Optional[int] = None,
                   memory_lengths=None, W=None):
        """``infer`` as one ``torch._higher_order_ops.while_loop`` over
        exactly S = max_steps steps with no early exit: the form that
        ``torch.export`` traces as a loop (export.py), not as S unrolled
        steps. The carry is a flat tuple of fixed-shape tensors: the step
        counter (a 0-dim int64 tensor), ``_open_step``'s state, previous
        frame, ``finished`` and ``length``, and the (S, B, K*M) mel, (S, B)
        gate and (S, B, T_in) alignment buffers, written with
        ``index_copy`` since the body may not mutate its inputs. Prenet
        dropout draws from the default generator (an exported program can
        take no ``torch.Generator``). ``W``: precomputed scan weights.
        Returns what ``infer`` returns."""
        from torch._higher_order_ops import while_loop

        hp = self.hp
        S = max_steps or hp.max_decoder_steps
        B, T_in, _ = memory.shape
        K, M = hp.n_frames_per_step, hp.n_mel_channels
        processed_memory, W, mask = self.open_loop_inputs(
            memory, memory_lengths, W)
        if not isinstance(W.wc, QuantizedMatrix):
            # A view of w_ih, whose prenet rows the body reads too: the
            # inputs of a while_loop may not alias each other.
            W = W._replace(wc=W.wc.clone())
        state, prev, finished, length, _ = self.infer_init(memory, S)
        n_state = len(state)

        def cond(t, *carry):
            return t < S

        def body(t, *carry):
            state = carry[:n_state]
            prev, finished, length = carry[n_state:n_state + 3]
            (state, prev, finished, length, _), outs = self._open_step(
                (state, prev, finished, length, t), None, memory,
                processed_memory, W, mask)
            idx = t.reshape(1)
            bufs = [buf.index_copy(0, idx, out[None]) for buf, out in
                    zip(carry[n_state + 3:], outs)]
            return (t + 1, *state, prev, finished, length, *bufs)

        carry = while_loop(cond, body, (
            torch.zeros((), dtype=torch.long, device=memory.device), *state,
            prev, finished, length, memory.new_zeros(S, B, K * M),
            memory.new_zeros(S, B), memory.new_zeros(S, B, T_in)))
        length = carry[n_state + 3]
        mels, gates, attns = carry[n_state + 4:]
        mel_bmt = mels.transpose(0, 1).reshape(B, S * K, M).transpose(1, 2)
        return (mel_bmt, gates.T.repeat_interleave(K, dim=1),
                attns.transpose(0, 1), length * K)

    # -- streaming ------------------------------------------------------------
    def infer_init(self, memory, cap: int):
        """The carry of ``_open_step`` before the first step of a decode,
        with every length at the decoder cap ``cap``."""
        B = memory.shape[0]
        hp = self.hp
        return (self._init_state(memory),
                memory.new_zeros(B, hp.n_frames_per_step * hp.n_mel_channels),
                torch.zeros(B, dtype=torch.bool, device=memory.device),
                torch.full((B,), cap, dtype=torch.long, device=memory.device),
                0)

    @torch.no_grad()
    def infer_segment(self, memory, carry, generator, n_steps: int, inputs,
                      early_exit: bool = False):
        """``n_steps`` free-running steps from ``carry``; ``inputs`` is
        ``open_loop_inputs(memory, memory_lengths)``, computed once for all
        segments of a decode. Every decode runs here, through ``_open_step``
        (so ``qmm`` serves it with ``hp.quantized_inference``). Prenet
        dropout draws from ``generator`` in step order: carrying one
        generator across segments gives the stream of ``infer`` for the same
        generator, whatever the segment size. With ``early_exit`` it stops
        once every gate has fired (one host sync a step; the outputs keep
        ``n_steps`` steps, zero after the last one run), else it never syncs.

        Returns (carry, mel (B, n_mel, n_steps*K), gate (B, n_steps*K),
        alignments (B, n_steps, T_in), lengths (B,) in frames, all_finished
        (a 0-dim bool tensor))."""
        hp = self.hp
        B, T_in, _ = memory.shape
        K, M = hp.n_frames_per_step, hp.n_mel_channels
        processed_memory, W, mask = inputs
        mels = memory.new_zeros(n_steps, B, K * M)
        gates = memory.new_zeros(n_steps, B)
        attns = memory.new_zeros(n_steps, B, T_in)
        with span("decoder.loop"):
            for t in range(n_steps):
                with span("decoder.step", events=False):
                    carry, (mels[t], gates[t], attns[t]) = self._open_step(
                        carry, generator, memory, processed_memory, W, mask)
                    done = early_exit and bool(carry[2].all())
                if done:
                    break
        mel_bmt = mels.transpose(0, 1).reshape(B, n_steps * K, M) \
            .transpose(1, 2)
        return (carry, mel_bmt, gates.T.repeat_interleave(K, dim=1),
                attns.transpose(0, 1), carry[3] * K, carry[2].all())


class Tacotron2(nn.Module):
    """GANtron generator. Weights are drawn from ``seed`` on the CPU (so
    every device gets the same ones) and moved to ``device``. With
    ``hp.style_reconstruction_weight > 0`` (and noise) it also holds the
    InfoGAN ``style_encoder``. Every submodule owns its parameters from
    construction, so the port needs no counterpart of the JAX package's
    ``init_full``, which exists to make Flax create the style encoder's
    parameters."""

    def __init__(self, hp, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.hp = hp
        std = math.sqrt(2.0 / (hp.n_symbols + hp.symbols_embedding_dim))
        val = math.sqrt(3.0) * std

        def uniform(*shape):
            return nn.Parameter((torch.rand(shape, generator=g) * 2 - 1) * val)

        self.embedding = uniform(hp.n_symbols, hp.symbols_embedding_dim)
        if hp.vesus_path:
            # Same bound as the symbol table, as in the reference.
            self.speaker_embedding = uniform(N_SPEAKERS, hp.speakers_embedding)
        enc_in = hp.symbols_embedding_dim
        if hp.encoder_inputs:
            enc_in += self.noise_size + (N_EMOTIONS if self.use_labels else 0)
        self.encoder = Encoder(hp, enc_in, g)
        self.decoder = Decoder(hp, self.memory_dim, g)
        self.postnet = Postnet(hp, g)
        if self.style_reconstruction:
            self.style_encoder = StyleEncoder(hp, self.style_code_dims, g)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    @property
    def use_labels(self) -> bool:
        return bool(self.hp.use_labels and self.hp.vesus_path)

    @property
    def noise_size(self) -> int:
        return self.hp.noise_size if self.hp.use_noise else 0

    @property
    def style_reconstruction(self) -> bool:
        return self.hp.style_reconstruction_weight > 0 and self.noise_size > 0

    @property
    def style_code_dims(self) -> int:
        """Identifiable-code width: the first ``hp.style_code_dims`` dims of
        the style vector (the whole vector when it is 0)."""
        return int(self.hp.style_code_dims) or self.noise_size

    @property
    def memory_dim(self) -> int:
        """Decoder-side memory width after all concats."""
        hp = self.hp
        d = hp.encoder_embedding_dim
        if not hp.encoder_inputs:
            d += self.noise_size
        if hp.vesus_path:
            d += hp.speakers_embedding
            if self.use_labels and not hp.encoder_inputs:
                d += N_EMOTIONS
        return d

    # -- conditioning plumbing ----------------------------------------------
    def _style(self, style, B, dtype, noise_generator):
        if style is None:
            style = draw(torch.rand, (B, 1, self.noise_size),
                         noise_generator, device=self.device)
        return style.to(dtype)

    def _encoder_side_concat(self, embedded, emotions, noise_generator, style):
        """Emotion/noise channels appended to the conv stack input when
        hp.encoder_inputs."""
        hp = self.hp
        B, T = embedded.shape[:2]
        parts = [embedded]
        if hp.encoder_inputs and self.use_labels and emotions is not None:
            parts.append(emotions[:, None, :].to(embedded.dtype)
                         .expand(B, T, N_EMOTIONS))
        if hp.encoder_inputs and self.noise_size > 0:
            style = self._style(style, B, embedded.dtype, noise_generator)
            parts.append(style.expand(B, T, self.noise_size))
        return torch.cat(parts, -1) if len(parts) > 1 else embedded

    def _memory_side_concat(self, encoder_outputs, speaker_ids, emotions,
                            noise_generator, style):
        """Speaker/emotion/noise channels appended to the decoder memory."""
        hp = self.hp
        B, T = encoder_outputs.shape[:2]
        dtype = encoder_outputs.dtype
        parts = [encoder_outputs]
        if hp.vesus_path:
            spk = self.speaker_embedding[speaker_ids]
            parts.append(spk[:, None, :].to(dtype)
                         .expand(B, T, hp.speakers_embedding))
            if self.use_labels and not hp.encoder_inputs \
                    and emotions is not None:
                parts.append(emotions[:, None, :].to(dtype)
                             .expand(B, T, N_EMOTIONS))
        if not hp.encoder_inputs and self.noise_size > 0:
            style = self._style(style, B, dtype, noise_generator)
            parts.append(style.expand(B, T, self.noise_size))
        return torch.cat(parts, -1) if len(parts) > 1 else encoder_outputs

    # -- training forward ---------------------------------------------------
    def forward(self, text, text_lengths, mels, speaker_ids, emotions,
                output_lengths, train: bool = True, style=None,
                generator: torch.Generator = None,
                noise_generator: torch.Generator = None, dw_offsets=None):
        """Teacher-forced forward of a padded batch on the model's device.
        ``style``: optional (B, 1, noise_size) overriding the U[0, 1) draw
        from ``noise_generator``; ``generator`` drives every dropout. The
        compute dtype is the parameters' and ``mels``' (bfloat16 copies of
        both in mixed-precision training); BatchNorm statistics stay float32.
        ``dw_offsets``: the decoder's deferred-dW offsets
        (``Decoder.forward``); with them the result is (outputs, dw_aux).

        Returns [mel, mel_postnet, gate, alignments] with frames past each
        output length masked (mel -> 0, gate energy -> 1e3)."""
        hp = self.hp
        embedded = self.embedding[text]
        embedded = self._encoder_side_concat(
            embedded, emotions, noise_generator,
            style if hp.encoder_inputs else None)
        encoder_outputs = self.encoder(embedded, text_lengths, train=train,
                                       generator=generator)
        memory = self._memory_side_concat(
            encoder_outputs, speaker_ids, emotions, noise_generator,
            None if hp.encoder_inputs else style)
        dec_out = self.decoder(memory, mels, text_lengths, train, generator,
                               dw_offsets)
        mel, gate, alignments = dec_out[:3]
        mel_postnet = mel + self.postnet(mel, train, generator)
        outputs = self.parse_output([mel, mel_postnet, gate, alignments],
                                    output_lengths)
        return outputs if dw_offsets is None else (outputs, dec_out[3])

    def predict_style(self, mel_bmt, lengths):
        """InfoGAN Q head: free-running mel (B, n_mel, T) and valid frame
        lengths (B,) -> predicted style code (B, style_code_dims) in (0, 1).
        Only with ``hp.style_reconstruction_weight > 0``."""
        return self.style_encoder(mel_bmt, lengths)

    def parse_output(self, outputs, output_lengths=None):
        """Mask frames past each output length: mels to 0, gate energies to
        1e3 (with ``hp.mask_padding``)."""
        if self.hp.mask_padding and output_lengths is not None:
            valid = get_mask_from_lengths(output_lengths, outputs[0].shape[2])
            outputs[0] = outputs[0].masked_fill(~valid[:, None, :], 0.0)
            outputs[1] = outputs[1].masked_fill(~valid[:, None, :], 0.0)
            outputs[2] = outputs[2].masked_fill(~valid, 1e3)
        return outputs

    # -- inference ----------------------------------------------------------
    @torch.no_grad()
    def encode_memory(self, text, style=None, emotions=None, speaker=None,
                      text_lengths=None, noise_generator=None):
        """``_encode_memory`` without autograd history."""
        return self._encode_memory(text, style, emotions, speaker,
                                   text_lengths, noise_generator)

    def _encode_memory(self, text, style=None, emotions=None, speaker=None,
                       text_lengths=None, noise_generator=None):
        """Text (B, T) ids -> decoder memory (B, T, memory_dim) with all
        conditioning concats applied. ``style``: optional (B, 1, noise_size)
        or (B, T, noise_size); drawn U[0, 1) from ``noise_generator`` when
        None. ``text_lengths``: optional true lengths of a PADDED batch: the
        encoder convs and LSTM then never see pad positions. ``emotions``
        (B, 5) and ``speaker`` ids (B,) may be arrays or tensors on any
        device."""
        hp = self.hp
        text = text.to(self.device, torch.long)
        B, T = text.shape
        if emotions is not None:
            emotions = torch.as_tensor(emotions, dtype=torch.float32,
                                       device=self.device)
        if self.use_labels and emotions is None:
            emotions = draw(torch.rand, (B, N_EMOTIONS), noise_generator,
                            device=self.device)
        if style is not None:
            style = style.to(self.device)
            if style.dim() == 3 and style.shape[1] not in (1, T):
                raise ValueError("style must broadcast over input positions")
        enc_style = style if hp.encoder_inputs else None
        mem_style = None if hp.encoder_inputs else style

        embedded = self.embedding[text]
        embedded = self._encoder_side_concat(embedded, emotions,
                                             noise_generator, enc_style)
        if text_lengths is not None:
            lengths = text_lengths.to(self.device, torch.long)
            enc_mask = get_mask_from_lengths(lengths, T)
        else:
            lengths = torch.full((B,), T, dtype=torch.long, device=self.device)
            enc_mask = None
        encoder_outputs = self.encoder(embedded, lengths, mask=enc_mask)
        spk = (torch.as_tensor(speaker, device=self.device).long()
               if speaker is not None
               else torch.zeros(B, dtype=torch.long, device=self.device))
        return self._memory_side_concat(
            encoder_outputs, spk, None if hp.encoder_inputs else emotions,
            noise_generator, mem_style)

    @torch.no_grad()
    @spanned("tacotron2.infer")
    def infer(self, text, style=None, emotions=None, speaker=None,
              max_steps: Optional[int] = None, early_exit: bool = False,
              text_lengths=None, generator=None, noise_generator=None):
        """Free-running inference. ``generator`` drives the prenet dropout,
        ``noise_generator`` the style (and emotion) draws. Returns [mel,
        mel_postnet, gate, alignments, mel_lengths]."""
        memory = self.encode_memory(text, style, emotions, speaker,
                                    text_lengths, noise_generator)
        memory_lengths = (text_lengths.to(self.device, torch.long)
                          if text_lengths is not None else None)
        decode = (self.decoder.infer_early_exit if early_exit
                  else self.decoder.infer)
        mel, gate, alignments, mel_lengths = decode(
            memory, generator, max_steps, memory_lengths=memory_lengths)
        mel_postnet = mel + self.postnet(mel)
        return [mel, mel_postnet, gate, alignments, mel_lengths]

    def rollout(self, text, style=None, emotions=None, speaker=None,
                n_steps: int = None, text_lengths=None, generator=None,
                noise_generator=None):
        """``infer`` of exactly ``n_steps`` steps (default
        hp.max_decoder_steps) with autograd history (``Decoder.rollout``):
        the free-running decode that the G step's adversarial rollouts and
        identification terms differentiate through. The encoder and the
        postnet run as in ``infer`` (running BatchNorm statistics, no
        dropout); the prenet's dropout draws from ``generator``. Returns
        [mel, mel_postnet, gate, alignments, mel_lengths]."""
        memory = self._encode_memory(text, style, emotions, speaker,
                                     text_lengths, noise_generator)
        memory_lengths = (text_lengths.to(self.device, torch.long)
                          if text_lengths is not None else None)
        mel, gate, alignments, mel_lengths = self.decoder.rollout(
            memory, generator, n_steps or self.hp.max_decoder_steps,
            memory_lengths)
        mel_postnet = mel + self.postnet(mel)
        return [mel, mel_postnet, gate, alignments, mel_lengths]

    # -- streaming ------------------------------------------------------------
    @torch.no_grad()
    def postnet_residual(self, mel_bmt):
        """mel + postnet(mel) over a (B, n_mel, T) window (streaming runs it
        on overlapping windows)."""
        return mel_bmt + self.postnet(mel_bmt)
