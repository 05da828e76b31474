"""Floating-point operations of a Flowtron training step, counted as the
program runs them (``flops.py``'s rules: matrix products and convolutions
only, 2 operations a multiply-add, as ``FlopCounterMode`` counts the
reference's forward; a step is the forward plus twice it for the
backward). The flows' LSTMs run length-packed, so they are counted over the
batch's valid frames (the sum of its mel lengths); everything else over
the padded shapes it is computed on: the encoder, the query, the dense
layers, the conv, the gate and the attention's whole (frames x characters)
grid. With every frame valid the count is the reference's.

A frame of one flow at LJSpeech's widths is about 26.8M multiply-adds in
its matrices (the attention LSTM 4.5M, the two-layer LSTM 19.4M, the
dense layers 2.1M, the query 0.66M, the conv 0.16M); the attention's grid
adds 2 x 640 multiply-adds a character (the scores' product with v and
the context's with the values).
"""


def encoder_flops(m, B: int, T_in: int) -> int:
    """Tacotron 2's encoder over the padded text: the convs and the
    BiLSTM."""
    E, k = m["encoder_embedding_dim"], m["encoder_kernel_size"]
    dims = [m["n_text_dim"]] + [E] * m["encoder_n_convolutions"]
    convs = sum(2 * B * T_in * dims[i] * E * k
                for i in range(m["encoder_n_convolutions"]))
    H = E // 2
    return convs + 2 * B * T_in * 2 * (E * 4 * H + H * 4 * H)


def flow_flops(m, B: int, T_in: int, T_out: int, gate: bool,
               valid: int = None) -> int:
    """One flow's forward over the padded (B, T_out) frames, its LSTMs over
    ``valid`` of them (by default every one)."""
    M, H, A = m["n_mel_channels"], m["n_hidden"], m["n_attn_channels"]
    D = m["n_text_dim"] + m["n_speaker_dim"]
    frames = B * T_out
    valid = frames if valid is None else valid
    lstm_ins = [M, H + A] + [H] * (m["n_lstm_layers"] - 1)
    lstms = sum(2 * valid * (n_in + H) * 4 * H for n_in in lstm_ins)
    keys_values = 2 * 2 * B * T_in * D * A
    query = 2 * frames * H * A
    grid = 2 * frames * T_in * A * 2
    dense = 2 * 2 * frames * H * H
    conv = 2 * frames * H * 2 * M
    return (lstms + keys_values + query + grid + dense + conv
            + (2 * frames * (H + A) if gate else 0))


def forward_flops(m, B: int, T_in: int, T_out: int, valid: int = None) -> int:
    """The forward; ``valid`` the batch's valid frames (its mel lengths'
    sum), by default every frame."""
    n = m["n_flows"]
    return encoder_flops(m, B, T_in) + sum(
        flow_flops(m, B, T_in, T_out,
                   bool(m["use_gate_layer"]) and f == n - 1, valid)
        for f in range(n))


def step_flops(m, B: int, T_in: int, T_out: int, valid: int = None) -> int:
    """A training step: the forward plus twice it for the backward."""
    return 3 * forward_flops(m, B, T_in, T_out, valid)
