"""The whole training's share of the cards' peak: the operations of the
G/G/D cycles the window completed (``counts.flops.train_cycle_flops``, the
padded global batch, forward plus twice it for the backward) over the
window's seconds, against the dense bfloat16 peak of every card the cell
ran on, in percent."""

from perfbench.counts.peaks import PEAK_BF16_FLOPS


def read(run):
    if not run.count.get("cycles"):
        return None
    return (100.0 * run.count["flops"] / run.window_s
            / (run.chips * PEAK_BF16_FLOPS))
