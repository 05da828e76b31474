"""The whole synthesis's share of the card's peak: the operations of the
requests the window completed (``counts.flops.synthesis_flops``, each
request's own frames) over the window's seconds, against the dense
bfloat16 peak, in percent."""

from perfbench.counts.peaks import PEAK_BF16_FLOPS


def read(run):
    if not run.count.get("requests"):
        return None
    return 100.0 * run.count["flops"] / run.window_s / PEAK_BF16_FLOPS
