"""Plain Tacotron 2 with GANtron's conditioning, in float32.

Shapes follow NVIDIA's tacotron2 (hparams.py widths) with GANtron's
additions (Brechard/GANtron model.py): a uniform noise vector of
``noise_size`` appended to every encoder output, and, for VESUS, a speaker
embedding and the five emotion intensities appended before it. The decoder
runs one step at a time: prenet (two ReLU layers, dropout 0.5 after each,
kept at inference), the attention LSTM, location-sensitive attention (a
conv over the previous and cumulative weights, a dense map, tanh energies,
softmax over the valid inputs), the decoder LSTM, and the mel and gate
projections of [decoder state, context]. The postnet is five convs with
BatchNorm, tanh after all but the last.

Weights are a dict ``W`` of float32 tensors under the names of
``param_shapes``; matrices that activations multiply from the right are
(in, out), convolutions (out, in, k), the location conv (k, 2, filters),
and each LSTM has ``w_ih`` (in, 4H), ``w_hh`` (H, 4H) and one bias ``b``
with the gates in the order i, f, g, o. Only one mel frame a decoder step
is implemented (``n_frames_per_step`` 1).

Dropout keeps a unit where a uniform draw of the unit's shape is below
1 - p and scales it by 1 / (1 - p); every draw takes the generator that the
caller passes, in the order the layers run. For a data-parallel group the
caller passes the ranks' generators, one a rank: each draws its rank's
equal share of the batch's rows, in rank order (``uniform``). ``cfg`` is
the ``model`` dict of a configuration file under ``perfbench/configs``.
"""

import math

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Precision, quantize_per_channel

N_SPEAKERS = 123


def memory_dim(m) -> int:
    d = m["encoder_embedding_dim"]
    if m["vesus"]:
        d += m["speakers_embedding"]
        if m["use_labels"]:
            d += m["n_labels"]
    if m["use_noise"]:
        d += m["noise_size"]
    return d


def param_shapes(m) -> dict:
    """name -> shape of every generator tensor, BatchNorm statistics
    included, in the order the benchmark draws them."""
    if m["n_frames_per_step"] != 1:
        raise NotImplementedError("the reference decodes one frame a step")
    E, k, M = (m["encoder_embedding_dim"], m["encoder_kernel_size"],
               m["n_mel_channels"])
    P, A, R = m["prenet_dim"], m["attention_rnn_dim"], m["decoder_rnn_dim"]
    att, F_, lk = (m["attention_dim"], m["attention_location_n_filters"],
                   m["attention_location_kernel_size"])
    D = memory_dim(m)
    s = {"embedding": (m["n_symbols"], m["symbols_embedding_dim"])}
    if m["vesus"]:
        s["speaker_embedding"] = (N_SPEAKERS, m["speakers_embedding"])
    dims = [m["symbols_embedding_dim"]] + [E] * m["encoder_n_convolutions"]
    for i in range(m["encoder_n_convolutions"]):
        s[f"encoder.convs.{i}.conv.weight"] = (E, dims[i], k)
        s[f"encoder.convs.{i}.conv.bias"] = (E,)
    for i in range(m["encoder_n_convolutions"]):
        for n in ("weight", "bias", "running_mean", "running_var"):
            s[f"encoder.bns.{i}.{n}"] = (E,)
    for d in ("fw", "bw"):
        s[f"encoder.lstm_{d}.w_ih"] = (E, 2 * E)
        s[f"encoder.lstm_{d}.w_hh"] = (E // 2, 2 * E)
        s[f"encoder.lstm_{d}.b"] = (2 * E,)
    s.update({
        "decoder.prenet_w0": (M, P), "decoder.prenet_w1": (P, P),
        "decoder.query_w": (A, att), "decoder.memory_w": (D, att),
        "decoder.v_w": (att, 1), "decoder.loc_conv_w": (lk, 2, F_),
        "decoder.loc_dense_w": (F_, att), "decoder.proj_w": (R + D, M),
        "decoder.proj_b": (M,), "decoder.gate_w": (R + D, 1),
        "decoder.gate_b": (1,),
        "decoder.attention_rnn.w_ih": (P + D, 4 * A),
        "decoder.attention_rnn.w_hh": (A, 4 * A),
        "decoder.attention_rnn.b": (4 * A,),
        "decoder.decoder_rnn.w_ih": (A + D, 4 * R),
        "decoder.decoder_rnn.w_hh": (R, 4 * R),
        "decoder.decoder_rnn.b": (4 * R,),
    })
    n, pe, pk = (m["postnet_n_convolutions"], m["postnet_embedding_dim"],
                 m["postnet_kernel_size"])
    pd = [M] + [pe] * (n - 1) + [M]
    for i in range(n):
        s[f"postnet.convs.{i}.conv.weight"] = (pd[i + 1], pd[i], pk)
        s[f"postnet.convs.{i}.conv.bias"] = (pd[i + 1],)
    for i in range(n):
        for nm in ("weight", "bias", "running_mean", "running_var"):
            s[f"postnet.bns.{i}.{nm}"] = (pd[i + 1],)
    return s


# -- pieces -----------------------------------------------------------------
def uniform(shape, gen, device, batch_dim=0):
    """U(0, 1) draws of ``shape`` from ``gen``: a generator, or a list of the
    ranks' generators, each of which draws its rank's equal share of
    dimension ``batch_dim`` (the batch's rows), joined in rank order."""
    if isinstance(gen, torch.Generator):
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float32)
    part = list(shape)
    if part[batch_dim] % len(gen):
        raise ValueError(f"{part[batch_dim]} rows do not split over "
                         f"{len(gen)} ranks")
    part[batch_dim] //= len(gen)
    return torch.cat([torch.rand(part, generator=g, device=device,
                                 dtype=torch.float32) for g in gen],
                     dim=batch_dim)


def dropout(x, p, gen, batch_dim=0):
    keep = uniform(x.shape, gen, x.device, batch_dim) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), 0.0)


def lstm(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def batch_norm(W, name, x, train, eps=1e-5):
    """BatchNorm over channel axis 1 of (B, C, T): the batch's mean and
    biased variance over (B, T) in training, the running ones otherwise."""
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2), unbiased=False)
    else:
        mean, var = W[name + ".running_mean"], W[name + ".running_var"]
    scale = W[name + ".weight"] * torch.rsqrt(var + eps)
    return (x - mean[None, :, None]) * scale[None, :, None] \
        + W[name + ".bias"][None, :, None]


def lengths_mask(lengths, T):
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def _masked_lstm(P_, x, w_ih, w_hh, b, lengths):
    """One LSTM direction over (B, T, in): state held and output zero past
    each length."""
    B, T, _ = x.shape
    H = w_hh.shape[0]
    xp = P_.mm(x, w_ih) + b
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    outs = []
    for t in range(T):
        hn, cn = lstm(xp[:, t] + P_.mm(h, w_hh), c)
        valid = (t < lengths)[:, None]
        h, c = torch.where(valid, hn, h), torch.where(valid, cn, c)
        outs.append(torch.where(valid, hn, 0.0))
    return torch.stack(outs, dim=1)


def _reverse_valid(x, lengths):
    B, T, D = x.shape
    t = torch.arange(T, device=x.device)[None, :]
    idx = torch.clamp(lengths[:, None] - 1 - t, 0, T - 1)
    out = torch.gather(x, 1, idx[..., None].expand(B, T, D))
    return torch.where((t < lengths[:, None])[..., None], out, 0.0)


def encoder(W, m, ids, lengths, train=False, gen=None, P_=Precision()):
    """(B, T) ids -> (B, T, E). At inference each conv sees zeros past a
    text's length (the padded batch reads as the unpadded texts); in
    training the convs see the padded batch and BatchNorm its statistics,
    with dropout 0.5 after every conv."""
    x = W["embedding"][ids].transpose(1, 2)
    mask = lengths_mask(lengths, ids.shape[1])
    k = m["encoder_kernel_size"]
    for i in range(m["encoder_n_convolutions"]):
        if not train:
            x = x.masked_fill(~mask[:, None, :], 0.0)
        name = f"encoder.convs.{i}.conv"
        x = P_.conv1d(x, W[name + ".weight"], W[name + ".bias"],
                      padding=(k - 1) // 2)
        x = F.relu(batch_norm(W, f"encoder.bns.{i}", x, train))
        if train:
            x = dropout(x, 0.5, gen)
    x = x.transpose(1, 2)
    fw = _masked_lstm(P_, x, W["encoder.lstm_fw.w_ih"],
                      W["encoder.lstm_fw.w_hh"], W["encoder.lstm_fw.b"],
                      lengths)
    bw = _masked_lstm(P_, _reverse_valid(x, lengths),
                      W["encoder.lstm_bw.w_ih"], W["encoder.lstm_bw.w_hh"],
                      W["encoder.lstm_bw.b"], lengths)
    return torch.cat([fw, _reverse_valid(bw, lengths)], dim=-1)


def memory(W, m, enc, style, speaker=None, emotions=None):
    """The decoder's memory: encoder outputs, then the speaker embedding
    and the emotions (VESUS), then the style noise, at every position."""
    B, T, _ = enc.shape
    parts = [enc]
    if m["vesus"]:
        parts.append(W["speaker_embedding"][speaker][:, None, :]
                     .expand(B, T, m["speakers_embedding"]))
        if m["use_labels"]:
            parts.append(emotions[:, None, :].expand(B, T, m["n_labels"]))
    if m["use_noise"]:
        parts.append(style.expand(B, T, m["noise_size"]))
    return torch.cat(parts, dim=-1)


def recurrence_weights(W, m, bits=None):
    """The four recurrence matrices the decoder multiplies every step:
    float, or quantized per output channel with ``bits`` bits."""
    P = m["prenet_dim"]
    mats = {"wc": W["decoder.attention_rnn.w_ih"][P:],
            "wh1": W["decoder.attention_rnn.w_hh"],
            "w2ih": W["decoder.decoder_rnn.w_ih"],
            "w2hh": W["decoder.decoder_rnn.w_hh"]}
    if bits:
        mats = {k: quantize_per_channel(v, bits) for k, v in mats.items()}
    return mats


def prenet(W, x, gen, P_):
    """(T, B, n_mel) frames -> (T, B, prenet_dim)."""
    x = dropout(F.relu(P_.mm(x, W["decoder.prenet_w0"])), 0.5, gen, 1)
    return dropout(F.relu(P_.mm(x, W["decoder.prenet_w1"])), 0.5, gen, 1)


def decoder_init(m, mem):
    B, T, D = mem.shape
    A, R = m["attention_rnn_dim"], m["decoder_rnn_dim"]
    z = mem.new_zeros
    return (z(B, A), z(B, A), z(B, R), z(B, R), z(B, T), z(B, T), z(B, D))


def decoder_step(W, m, state, proj_t, mem, pmem, mask, R_, P_, train=False,
                 gen=None):
    """One step of both LSTMs and the attention. ``proj_t``: the prenet
    output times the attention LSTM's prenet rows, plus its bias."""
    attn_h, attn_c, dec_h, dec_c, attn_w, attn_cum, ctx = state
    gates = proj_t + P_.mm(ctx, R_["wc"]) + P_.mm(attn_h, R_["wh1"])
    attn_h, attn_c = lstm(gates, attn_c)
    if train and m["p_attention_dropout"] > 0:
        attn_h = dropout(attn_h, m["p_attention_dropout"], gen)
    pq = P_.mm(attn_h, W["decoder.query_w"])[:, None, :]
    k = m["attention_location_kernel_size"]
    loc = P_.conv1d(torch.stack([attn_w, attn_cum], dim=1),
                    W["decoder.loc_conv_w"].permute(2, 1, 0),
                    padding=(k - 1) // 2)
    loc = P_.mm(loc.transpose(1, 2), W["decoder.loc_dense_w"])
    energies = P_.mm(torch.tanh(pq + loc + pmem), W["decoder.v_w"])[..., 0]
    energies = energies.masked_fill(~mask, -math.inf)
    attn_w = torch.softmax(energies, dim=1)
    ctx = P_.mm(attn_w[:, None, :], mem)[:, 0]
    attn_cum = attn_cum + attn_w
    gates2 = (P_.mm(torch.cat([attn_h, ctx], dim=-1), R_["w2ih"])
              + P_.mm(dec_h, R_["w2hh"]) + W["decoder.decoder_rnn.b"])
    dec_h, dec_c = lstm(gates2, dec_c)
    if train and m["p_decoder_dropout"] > 0:
        dec_h = dropout(dec_h, m["p_decoder_dropout"], gen)
    return (attn_h, attn_c, dec_h, dec_c, attn_w, attn_cum, ctx)


def project(W, state, P_):
    hc = torch.cat([state[2], state[6]], dim=-1)
    return (P_.mm(hc, W["decoder.proj_w"]) + W["decoder.proj_b"],
            (P_.mm(hc, W["decoder.gate_w"]) + W["decoder.gate_b"])[:, 0])


def postnet(W, m, mel, train=False, gen=None, P_=Precision()):
    """(B, n_mel, T) -> the residual the postnet adds."""
    n, k = m["postnet_n_convolutions"], m["postnet_kernel_size"]
    x = mel
    for i in range(n):
        name = f"postnet.convs.{i}.conv"
        x = batch_norm(W, f"postnet.bns.{i}",
                       P_.conv1d(x, W[name + ".weight"], W[name + ".bias"],
                                 padding=(k - 1) // 2), train)
        if i < n - 1:
            x = torch.tanh(x)
        if train:
            x = dropout(x, 0.5, gen)
    return x


# -- serving ----------------------------------------------------------------
@torch.no_grad()
def decode_given_frames(W, m, ids, lengths, style, speaker, emotions, frames,
                        mask_draws, bits=None, P_=Precision()):
    """The decoder's prediction at every step when step t is fed the
    served frame t - 1 (zeros at t = 0): the reference read over the
    program's own outputs, so that a gap does not grow by feedback.

    ``frames``: (B, n_mel, S) served decoder frames (before the postnet);
    ``mask_draws(t)``: the two prenet dropout draws of step t, each a
    (B, prenet_dim) uniform tensor, in draw order. ``bits``: the
    recurrence matrices as ``bits``-bit integers (serving's int8), None for
    float. Returns the predicted frames (B, n_mel, S)."""
    enc = encoder(W, m, ids, lengths, P_=P_)
    mem = memory(W, m, enc, style, speaker, emotions)
    pmem = P_.mm(mem, W["decoder.memory_w"])
    mask = lengths_mask(lengths, ids.shape[1])
    R_ = recurrence_weights(W, m, bits)
    P = m["prenet_dim"]
    w_pre, b_att = W["decoder.attention_rnn.w_ih"][:P], \
        W["decoder.attention_rnn.b"]
    state = decoder_init(m, mem)
    B, M, S = frames.shape
    prev = frames.new_zeros(B, M)
    out = []
    for t in range(S):
        u0, u1 = mask_draws(t)
        x = F.relu(P_.mm(prev, W["decoder.prenet_w0"]))
        x = torch.where(u0 < 0.5, x / 0.5, 0.0)
        x = F.relu(P_.mm(x, W["decoder.prenet_w1"]))
        x = torch.where(u1 < 0.5, x / 0.5, 0.0)
        state = decoder_step(W, m, state, P_.mm(x, w_pre) + b_att, mem, pmem,
                             mask, R_, P_)
        mel_t, _ = project(W, state, P_)
        out.append(mel_t)
        prev = frames[:, :, t]
    return torch.stack(out, dim=2)


# -- training ---------------------------------------------------------------
def forward_train(W, m, ids, text_lengths, mels, output_lengths, style, gen,
                  P_=Precision(), speaker=None, emotions=None):
    """Teacher-forced training pass over a padded batch: step t reads the
    ground-truth frame t - 1 (a zero go frame at t = 0). Returns
    [mel, mel_postnet, gate, alignments] with frames past each output
    length masked: mels to 0, gate energies to 1e3."""
    enc = encoder(W, m, ids, text_lengths, train=True, gen=gen, P_=P_)
    mem = memory(W, m, enc, style, speaker, emotions)
    pmem = P_.mm(mem, W["decoder.memory_w"])
    mask = lengths_mask(text_lengths, ids.shape[1])
    R_ = recurrence_weights(W, m)
    P = m["prenet_dim"]
    B, M, T = mels.shape
    frames = torch.cat([mels.new_zeros(B, M, 1), mels[:, :, :-1]], dim=2)
    pre = prenet(W, frames.permute(2, 0, 1), gen, P_)  # (T, B, P)
    proj = P_.mm(pre, W["decoder.attention_rnn.w_ih"][:P]) \
        + W["decoder.attention_rnn.b"]
    state = decoder_init(m, mem)
    mel_out, gate_out, aligns = [], [], []
    for t, proj_t in enumerate(proj.unbind(0)):
        state = decoder_step(W, m, state, proj_t, mem, pmem, mask, R_, P_,
                             train=True, gen=gen)
        mel_t, gate_t = project(W, state, P_)
        mel_out.append(mel_t)
        gate_out.append(gate_t)
        aligns.append(state[4])
    mel = torch.stack(mel_out, dim=2)
    gate = torch.stack(gate_out, dim=1)
    mel_post = mel + postnet(W, m, mel, train=True, gen=gen, P_=P_)
    valid = lengths_mask(output_lengths, T)
    return [mel.masked_fill(~valid[:, None], 0.0),
            mel_post.masked_fill(~valid[:, None], 0.0),
            gate.masked_fill(~valid, 1e3), torch.stack(aligns, dim=1)]


def tacotron2_loss(out, mel_target, gate_target, text_lengths,
                   output_lengths):
    """(mel loss, gate loss, attention loss): the MSE of both mels and the
    BCE of the gate over the padded tensors, and the diagonal guide's BCE
    (target exp(-(t - c_n)^2 / 1.5) at c_n = floor(n (T_dec - 1) /
    (T_enc - 1)), each term clipped at 100, summed over the valid (n, t)
    and divided by T_enc * T_dec, then averaged over the batch)."""
    mel, mel_post, gate, align = out
    mel_loss = torch.mean((mel - mel_target) ** 2) \
        + torch.mean((mel_post - mel_target) ** 2)
    gate_loss = F.binary_cross_entropy_with_logits(gate, gate_target)
    B, T_out, T_in = align.shape
    n = torch.arange(T_in, device=align.device)[None, :, None]
    t = torch.arange(T_out, device=align.device)[None, None, :]
    enc = text_lengths.long()[:, None, None]
    dec = output_lengths.long()[:, None, None]
    centers = torch.div(n * (dec - 1), torch.clamp(enc - 1, min=1),
                        rounding_mode="floor")
    target = torch.exp(-((t.float() - centers.float()) ** 2) / 1.5)
    a = torch.clamp(align.transpose(1, 2), 1e-12, 1.0 - 1e-12)
    bce = -(target * torch.log(a) + (1.0 - target) * torch.log1p(-a))
    bce = torch.where((n < enc) & (t < dec), torch.clamp(bce, max=100.0),
                      0.0)
    denom = (text_lengths * output_lengths).float()
    attn_loss = torch.mean(bce.sum(dim=(1, 2)) / denom)
    return mel_loss, gate_loss, attn_loss
