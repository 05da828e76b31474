"""Plain Flowtron in float32 (Valle et al., arXiv:2005.05957; NVIDIA/flowtron
``flowtron.py``): its weight draw, its training pass and loss, and its
inference, for the benchmark's check of ``flowtron_ljs.train_b64`` and for
the CPU tests.

The memory is Tacotron 2's encoder (``reference.tacotron2.encoder``) over
the text's embedding, with the speaker's embedding appended at every
character. Each flow k, time-major as the source writes it, over the frames
x (the second flow over each sequence reversed in time, its padding kept at
the end): x0 = [0; x_0 .. x_{T-2}]; a = LSTM_att(x0); q = a W_q, K = M W_k,
V = M W_v; e_tj = v . tanh(q_t + K_j), -inf past the text; alpha =
softmax_j(e); c_t = sum_j alpha_tj V_j; d = [a ; c]; the gate d W_g + b_g
(last flow only); l = LSTM_2(d), two layers; u = tanh(W_2 tanh(W_1 l + b_1)
+ b_2); [log s ; b] = u W_c + b_c; x' = exp(log s) x + b. After the second
flow x' (and only x') is put back in time order. Loss (sigma from the
configuration): sum m z^2 / 2 sigma^2 / N - sum_k sum m log s_k / N + sum
m BCE(gate, target) / sum m, with m the valid frames and N = sum m n_mel.
Inference runs the flows in reverse order, x_t = (z_t - b_t) / exp(log s_t)
frame by frame.

Every LSTM is an explicit cell loop (state held, output zero past each
length); every matrix product and convolution goes through a ``Precision``
(``precision.py``), so the controls can round its operands; the training
pass and the inference turn TF32 off (``set_tf32(False)``) before they
start. The attention runs in blocks of frames,
each recomputed in the backward (``torch.utils.checkpoint``), so that the
grid of a full-size batch fits beside the loops' saved states.

Departures from the source: no attention prior and no CTC loss (both
training aids of the source's ``train_config``); float32, not
``fp16_run``; the benchmark trains with Adam (``reference/optim.py``),
whatever optimizer the source's ``train_config`` names; the fixed Gaussian
alone (``n_components`` 0); the inference runs every sequence for the
latent's frames, with no stop at the gate; the encoder is Tacotron 2's as
the port has it, its convs normalised by BatchNorm over the whole padded
batch in training (running statistics at inference), where the source's
Flowtron builds its encoder with InstanceNorm1d and runs the convs one
sequence at a time, cut to its length (statistics of each sequence's own
characters, in training and at inference alike). The benchmark's weights are
random from the seed, the last conv of each flow included (the source
zero-initialises it, which would make every flow the identity and blind
the check): uniform with a standard deviation of ``CONV_STD``.
"""

import math

import torch
import torch.utils.checkpoint

from perfbench.reference import tacotron2 as ref_taco
from perfbench.reference.precision import Precision, set_tf32

# The standard deviation of each flow's last conv (weight and bias).
CONV_STD = 0.01
# Frames of the attention's grid computed at once.
ATTENTION_BLOCK = 64

_GAIN = {"linear": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0)}


def param_shapes(m) -> dict:
    """name -> shape of every tensor of the model, the encoder's BatchNorm
    statistics included, in the order the benchmark draws them (the names
    are the program's)."""
    E, k, M = (m["encoder_embedding_dim"], m["encoder_kernel_size"],
               m["n_mel_channels"])
    H, A = m["n_hidden"], m["n_attn_channels"]
    D = m["n_text_dim"] + m["n_speaker_dim"]
    s = {"embedding": (m["n_text"], m["n_text_dim"]),
         "speaker_embedding": (m["n_speakers"], m["n_speaker_dim"])}
    dims = [m["n_text_dim"]] + [E] * m["encoder_n_convolutions"]
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
    for f in range(m["n_flows"]):
        p = f"flows.{f}."
        s.update({p + "query_w": (H, A), p + "key_w": (D, A),
                  p + "value_w": (D, A), p + "v_w": (A, 1),
                  p + "dense_w0": (H, H), p + "dense_b0": (H,),
                  p + "dense_w1": (H, H), p + "dense_b1": (H,),
                  p + "conv_w": (H, 2 * M), p + "conv_b": (2 * M,)})
        if has_gate(m, f):
            s.update({p + "gate_w": (H + A, 1), p + "gate_b": (1,)})
        ins = [M] + [H + A] + [H] * (m["n_lstm_layers"] - 1)
        names = ["attention_lstm"] + [f"lstm.{i}"
                                      for i in range(m["n_lstm_layers"])]
        for name, n_in in zip(names, ins):
            s.update({f"{p}{name}.w_ih": (n_in, 4 * H),
                      f"{p}{name}.w_hh": (H, 4 * H),
                      f"{p}{name}.b": (4 * H,)})
    return s


def has_gate(m, f):
    return bool(m["use_gate_layer"]) and f == m["n_flows"] - 1


def _xavier(shape, gain):
    if len(shape) == 2:
        fan_in, fan_out = shape
    else:  # (out, in, k)
        fan_in, fan_out = shape[1] * shape[2], shape[0] * shape[2]
    return _GAIN[gain] * math.sqrt(6.0 / (fan_in + fan_out))


def _spread(name, shape, m):
    """(scale, offset) of U(-1, 1) for one tensor: the source's
    initialization (torch's defaults, ``LinearNorm``'s Xavier gains), the
    embeddings at unit variance as ``nn.Embedding`` draws them, BatchNorm
    near identity with running statistics spread around it, and each
    flow's last conv at ``CONV_STD``."""
    leaf = name.rsplit(".", 1)[-1]
    if name in ("embedding", "speaker_embedding"):
        return math.sqrt(3.0), 0.0
    if ".bns." in name:
        return {"weight": (0.1, 1.0), "bias": (0.1, 0.0),
                "running_mean": (0.1, 0.0),
                "running_var": (0.5, 1.0)}[leaf]
    if name.endswith("conv.weight"):
        return _xavier(shape, "relu"), 0.0
    if name.endswith("conv.bias"):
        return 1.0 / math.sqrt(shape[0] * 5), 0.0
    if leaf in ("w_ih", "w_hh", "b"):
        H = shape[-1] // 4
        return (2.0 if leaf == "b" else 1.0) / math.sqrt(H), 0.0
    if leaf in ("conv_w", "conv_b"):
        return CONV_STD * math.sqrt(3.0), 0.0
    if leaf in ("query_w", "key_w", "value_w"):
        return _xavier(shape, "tanh"), 0.0
    if leaf in ("dense_b0", "dense_b1"):
        return 1.0 / math.sqrt(shape[0]), 0.0
    if leaf == "gate_b":
        return 1.0 / math.sqrt(m["n_hidden"] + m["n_attn_channels"]), 0.0
    return _xavier(shape, "linear"), 0.0


def weights(m, generator, device) -> dict:
    """The model's float32 tensors (``param_shapes``), slices of one uniform
    draw on ``device`` from ``generator``, each scaled to its spread."""
    shapes = param_shapes(m)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=generator, device=device) * 2 - 1
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        scale, offset = _spread(name, shape, m)
        out[name] = (flat[at:at + n].view(shape) * scale
                     + offset).contiguous()
        at += n
    return out


# -- pieces -----------------------------------------------------------------
def reverse_by_length(x, lengths):
    """(B, T, C): the source's flip in time, then each sequence rolled by its
    length (``torch.roll``, one row at a time): the valid frames first in
    reverse order, the padding after them. Applied twice it is the
    identity."""
    flipped = torch.flip(x, (1,))
    return torch.stack([torch.roll(flipped[b], int(lengths[b]), dims=0)
                        for b in range(x.shape[0])])


def lstm_layer(P_, x, W, name, lengths):
    """One LSTM layer over (B, T, in), an explicit loop over frames."""
    return ref_taco._masked_lstm(P_, x, W[name + ".w_ih"], W[name + ".w_hh"],
                                 W[name + ".b"], lengths)


def _attention_block(P_, q, keys, values, v, mask):
    e = P_.mm(torch.tanh(q[:, :, None] + keys[:, None]), v)[..., 0]
    e = e.masked_fill(~mask[:, None, :], -math.inf)
    alpha = torch.softmax(e, dim=-1)
    return P_.mm(alpha, values), alpha


def attention(P_, q, keys, values, v, mask, block=ATTENTION_BLOCK):
    """Context (B, T, D) and weights (B, T, T_in) of the additive attention,
    ``block`` frames at a time."""
    ctx, alpha = [], []
    for t0 in range(0, q.shape[1], block):
        c, a = torch.utils.checkpoint.checkpoint(
            _attention_block, P_, q[:, t0:t0 + block], keys, values, v, mask,
            use_reentrant=False)
        ctx.append(c)
        alpha.append(a)
    return torch.cat(ctx, dim=1), torch.cat(alpha, dim=1)


def readout(P_, W, p, h):
    """[log s ; b] from the two-layer LSTM's output."""
    u = torch.tanh(P_.mm(h, W[p + "dense_w0"]) + W[p + "dense_b0"])
    u = torch.tanh(P_.mm(u, W[p + "dense_w1"]) + W[p + "dense_b1"])
    return (P_.mm(u, W[p + "conv_w"]) + W[p + "conv_b"]).chunk(2, dim=-1)


def memory(W, m, ids, text_lengths, speaker_ids, train=False, gen=None,
           P_=Precision()):
    """[encoder outputs ; speaker embedding] (B, T_in, D)."""
    enc = ref_taco.encoder(W, m, ids, text_lengths, train=train, gen=gen,
                           P_=P_)
    spk = W["speaker_embedding"][speaker_ids][:, None, :]
    return torch.cat([enc, spk.expand(-1, enc.shape[1], -1)], dim=-1)


def flow(W, m, f, x, mem, mask, lengths, P_):
    """Flow ``f`` over frames (B, T, n_mel): (x', log s, gate or None,
    attention weights)."""
    p = f"flows.{f}."
    x0 = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    a = lstm_layer(P_, x0, W, p + "attention_lstm", lengths)
    c, alpha = attention(P_, P_.mm(a, W[p + "query_w"]),
                         P_.mm(mem, W[p + "key_w"]),
                         P_.mm(mem, W[p + "value_w"]), W[p + "v_w"], mask)
    d = torch.cat([a, c], dim=-1)
    gate = ((P_.mm(d, W[p + "gate_w"]) + W[p + "gate_b"])[..., 0]
            if has_gate(m, f) else None)
    h = d
    for i in range(m["n_lstm_layers"]):
        h = lstm_layer(P_, h, W, f"{p}lstm.{i}", lengths)
    log_s, b = readout(P_, W, p, h)
    return torch.exp(log_s) * x + b, log_s, gate, alpha


# -- training ---------------------------------------------------------------
def forward_train(W, m, ids, text_lengths, mels, output_lengths, speaker_ids,
                  gen, P_=Precision()):
    """The training pass over a padded batch, mels (B, n_mel, T): the
    encoder in training mode (dropout drawn from ``gen``). Returns (z (B,
    n_mel, T), [log s (B, n_mel, T) a flow], the gate logits (B, T), [the
    attention weights (B, T, T_in) a flow])."""
    set_tf32(False)
    mem = memory(W, m, ids, text_lengths, speaker_ids, True, gen, P_)
    mask = ref_taco.lengths_mask(text_lengths, ids.shape[1])
    x = mels.transpose(1, 2)
    log_s_all, alphas, gate = [], [], None
    for f in range(m["n_flows"]):
        back = f % 2 == 1
        if back:
            x = reverse_by_length(x, output_lengths)
        x, log_s, g, alpha = flow(W, m, f, x, mem, mask, output_lengths, P_)
        if back:
            x = reverse_by_length(x, output_lengths)
        log_s_all.append(log_s.transpose(1, 2))
        alphas.append(alpha)
        gate = g if g is not None else gate
    return x.transpose(1, 2), log_s_all, gate, alphas


def loss(out, gate_target, output_lengths, sigma):
    """The flows' loss plus the gate's (module docstring)."""
    z, log_s, gate, _ = out
    B, M, T = z.shape
    m = ref_taco.lengths_mask(output_lengths, T).float()
    n = m.sum()
    nll = torch.sum((z * m[:, None]) ** 2) / (2 * sigma * sigma)
    for x in log_s:
        nll = nll - torch.sum(x * m[:, None])
    bce = torch.nn.functional.binary_cross_entropy_with_logits(
        gate, gate_target, reduction="none")
    return nll / (n * M) + torch.sum(bce * m) / n


# -- inference --------------------------------------------------------------
@torch.no_grad()
def infer(W, m, z, speaker_ids, ids, text_lengths, output_lengths,
          P_=Precision()):
    """The mel (B, n_mel, T) of latent z (B, n_mel, T): the flows inverted
    in reverse order, frame by frame, each reversed flow inside its
    reversal by ``output_lengths``; the encoder in inference mode."""
    set_tf32(False)
    mem = memory(W, m, ids, text_lengths, speaker_ids, P_=P_)
    mask = ref_taco.lengths_mask(text_lengths, ids.shape[1])
    x = z.transpose(1, 2)
    for f in reversed(range(m["n_flows"])):
        back = f % 2 == 1
        if back:
            x = reverse_by_length(x, output_lengths)
        x = _invert(W, m, f, x, mem, mask, P_)
        if back:
            x = reverse_by_length(x, output_lengths)
    return x.transpose(1, 2)


def _invert(W, m, f, z, mem, mask, P_):
    p = f"flows.{f}."
    B, T, M = z.shape
    keys, values = P_.mm(mem, W[p + "key_w"]), P_.mm(mem, W[p + "value_w"])
    names = ["attention_lstm"] + [f"lstm.{i}"
                                  for i in range(m["n_lstm_layers"])]
    H = m["n_hidden"]
    h = [z.new_zeros(B, H) for _ in names]
    c = [z.new_zeros(B, H) for _ in names]

    def cell(i, x):
        w = p + names[i]
        gates = (P_.mm(x, W[w + ".w_ih"]) + P_.mm(h[i], W[w + ".w_hh"])
                 + W[w + ".b"])
        h[i], c[i] = ref_taco.lstm(gates, c[i])
        return h[i]

    prev, out = z.new_zeros(B, M), []
    for t in range(T):
        a = cell(0, prev)
        ctx, _ = _attention_block(P_, P_.mm(a, W[p + "query_w"])[:, None],
                                  keys, values, W[p + "v_w"], mask)
        y = torch.cat([a, ctx[:, 0]], dim=-1)
        for i in range(1, len(names)):
            y = cell(i, y)
        log_s, b = readout(P_, W, p, y)
        prev = (z[:, t] - b) / torch.exp(log_s)
        out.append(prev)
    return torch.stack(out, dim=1)
