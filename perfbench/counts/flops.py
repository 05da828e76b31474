"""Floating-point operations of GANtron's work, counted from shapes.

Only matrix products and convolutions count, 2 operations a multiply-add,
as ``torch.utils.flop_counter.FlopCounterMode`` counts them; elementwise
work is left out. The counts follow the published model (the reference's
operations), not the program's code: the location conv and its dense map
count apart, the projections and the LSTMs' products as written.

Synthesis credits each request with its own frames: the decoder steps,
postnet frames and vocoder samples its text asks for, never the padding of
its batch. Training counts the padded batch as the collate makes it, the
forward pass plus twice it for the backward.
"""

from perfbench.reference.tacotron2 import memory_dim
from perfbench.reference import waveglow as wg


def encoder_flops(m, n_chars: int) -> int:
    E, k = m["encoder_embedding_dim"], m["encoder_kernel_size"]
    dims = [m["symbols_embedding_dim"]] + [E] * m["encoder_n_convolutions"]
    convs = sum(2 * n_chars * dims[i] * E * k
                for i in range(m["encoder_n_convolutions"]))
    H = E // 2
    lstm = 2 * n_chars * (2 * E * 4 * H + 2 * H * 4 * H)
    return convs + lstm


def decoder_step_flops(m, n_chars: int) -> int:
    """One free-running or teacher-forced decoder step over ``n_chars``
    inputs, prenet included."""
    M, P, A, R = (m["n_mel_channels"], m["prenet_dim"],
                  m["attention_rnn_dim"], m["decoder_rnn_dim"])
    att, F_, k = (m["attention_dim"], m["attention_location_n_filters"],
                  m["attention_location_kernel_size"])
    D = memory_dim(m)
    prenet = 2 * M * P + 2 * P * P
    attn_rnn = 2 * (P + D) * 4 * A + 2 * A * 4 * A
    attention = (2 * A * att + 2 * n_chars * 2 * k * F_
                 + 2 * n_chars * F_ * att + 2 * n_chars * att
                 + 2 * n_chars * D)
    dec_rnn = 2 * (A + D) * 4 * R + 2 * R * 4 * R
    proj = 2 * (R + D) * M + 2 * (R + D)
    return prenet + attn_rnn + attention + dec_rnn + proj


def postnet_flops(m, n_frames: int) -> int:
    n, pe, k, M = (m["postnet_n_convolutions"], m["postnet_embedding_dim"],
                   m["postnet_kernel_size"], m["n_mel_channels"])
    dims = [M] + [pe] * (n - 1) + [M]
    return sum(2 * n_frames * dims[i] * dims[i + 1] * k for i in range(n))


def tacotron2_flops(m, n_chars: int, n_frames: int) -> int:
    """Encoder, the memory projection, ``n_frames`` decoder steps (one
    frame a step) and the postnet."""
    return (encoder_flops(m, n_chars)
            + 2 * n_chars * memory_dim(m) * m["attention_dim"]
            + n_frames * decoder_step_flops(m, n_chars)
            + postnet_flops(m, n_frames))


def waveglow_flops(wc, n_frames: int, n_mel: int) -> int:
    """WaveGlow's inverse flow over ``n_frames`` mel frames (``wc``: the
    configuration's ``waveglow`` dict)."""
    G, n, L = wc["n_group"], wc["n_channels"], wc["n_layers"]
    Tg = n_frames * wc["upsample_stride"] // G
    total = 2 * n_frames * n_mel * n_mel * wc["upsample_kernel"]
    for k in range(wc["n_flows"]):
        c = wg.channels(wc, k)
        h = c // 2
        per_group = (2 * h * n + 2 * n_mel * G * 2 * n * L
                     + L * 2 * n * 2 * n * wc["kernel_size"]
                     + (L - 1) * 2 * n * 2 * n + 2 * n * n
                     + 2 * n * 2 * h + 2 * c * c)
        total += Tg * per_group
    return total


def synthesis_flops(cfg, n_chars: int, n_frames: int) -> int:
    """One request of a configuration: its text and its own frames, text to
    waveform."""
    m = cfg["model"]
    return tacotron2_flops(m, n_chars, n_frames) + waveglow_flops(
        cfg["waveglow"], n_frames, m["n_mel_channels"])


def discriminator_flops(m, batch: int, n_frames: int) -> int:
    """One forward of the conv discriminator over (batch, n_mel,
    n_frames) whole windows."""
    w, dim, M = m["discriminator_window"], m["discriminator_dim"], \
        m["n_mel_channels"]
    first = min((w * M // dim + 1) * dim, 1024)
    widths = [w * M, first, dim, dim, M]
    L = n_frames // w
    convs = sum(2 * L * widths[i] * widths[i + 1] * 5 for i in range(4))
    return batch * (convs + 2 * L * M)


def g_forward_flops(m, batch: int, t_in: int, t_out: int) -> int:
    """The teacher-forced forward of the padded batch, and the
    discriminator's forward over its postnet mel (the adversarial term)."""
    return (batch * tacotron2_flops(m, t_in, t_out)
            + discriminator_flops(m, batch, t_out))


def train_cycle_flops(m, batch: int, t_in: int, t_out: int) -> int:
    """Two G steps and one D step (real and generated mels), each its
    forward plus twice that for the backward."""
    g = 3 * g_forward_flops(m, batch, t_in, t_out)
    d = 3 * 2 * discriminator_flops(m, batch, t_out)
    return 2 * g + d
