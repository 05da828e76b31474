"""The whole Flowtron training's share of the cards' peak: the operations
of the steps the window completed (``counts.flowtron.step_flops`` of each
step's batch, its LSTMs over the valid frames, the rest over the padded
shapes, forward plus twice it for the backward) over the window's seconds,
against the dense bfloat16 peak of every card the cell ran on, in
percent."""

from perfbench.counts.peaks import PEAK_BF16_FLOPS


def read(run):
    if not run.count.get("steps"):
        return None
    return (100.0 * run.count["flops"] / run.window_s
            / (run.chips * PEAK_BF16_FLOPS))
