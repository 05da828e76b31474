"""Milliseconds of device time of the NCCL all-reduce kernels (the
gradients', the BatchNorm sums' and the metrics' reductions of the G and D
steps) in rank 0's profiled G/G/D cycle. Nothing to read on one card, or
where the exchange ran on no device (gloo)."""


def read(run):
    t = sum(s for n, s in run.profile["kernels"].items()
            if "nccl" in n.lower() and "allreduce" in n.lower())
    return 1e3 * t if t > 0 else None
