"""The least time of the decoder's int8 products (copied from the
program's chip_smoke.py ``qmm_bound``): bytes are the int8 weight, its
float32 scales, the activations in and the products out, once each;
operations are 2 * B * I * O at the float32 peak (the kernel widens the
int8 weights and sums in float32)."""

from perfbench.counts.peaks import HBM_BYTES_PER_S, PEAK_FP32_FLOPS
from perfbench.reference.tacotron2 import memory_dim


def qmm_bound_s(shapes, act_bytes: int = 4):
    """(seconds, "bytes" | "operations") for the products (B, I, O)."""
    nbytes = sum(I * O + 4 * O + B * I * act_bytes + B * O * act_bytes
                 for B, I, O in shapes)
    ops = sum(2 * B * I * O for B, I, O in shapes)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def decoder_step_products(m, batch: int):
    """The four recurrence products of one decoder step at ``batch``."""
    D, A, R = memory_dim(m), m["attention_rnn_dim"], m["decoder_rnn_dim"]
    return [(batch, D, 4 * A), (batch, A, 4 * A), (batch, A + D, 4 * R),
            (batch, R, 4 * R)]
