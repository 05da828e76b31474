"""A cell's process group as the benchmark sees it: one process a card,
joined through the program's own group (``programs/<name>.py``'s
``join_group``), and the few exchanges the harness and the traffic need
besides the program's. Rank 0, the chief, decides and reports."""

import time

import torch
import torch.distributed as dist


class Group:
    """This process's place in the group. ``origin``: the launching
    process's start, in seconds since the epoch, so that set-up counts
    from the command's start on every rank."""

    def __init__(self, rank, world, device, backend, origin):
        self.rank, self.world, self.origin = rank, world, origin
        # NCCL exchanges device tensors, gloo host ones.
        self.device = device if backend == "nccl" else torch.device("cpu")

    def since_start(self):
        return time.time() - self.origin

    def chief_says(self, flag):
        """Rank 0's ``flag`` on every rank."""
        x = torch.tensor([int(bool(flag))], device=self.device)
        dist.broadcast(x, 0)
        return bool(x.item())

    def max(self, value):
        """The largest ``value`` over the ranks."""
        x = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return float(x.item())

    def gather(self, obj):
        """Every rank's ``obj`` (picklable), in rank order, on every rank."""
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def gap_from_chief(self, tensors):
        """The largest |x - rank 0's x| over ``tensors`` (the same names and
        shapes on every rank) and over the ranks; 0 where all agree
        exactly."""
        gap = 0.0
        for t in tensors:
            x = t.detach().to(self.device, torch.float64, copy=True)
            dist.broadcast(x, 0)
            d = (t.detach().to(x) - x).abs().max()
            gap = max(gap, float(torch.nan_to_num(d, nan=float("inf"))))
        return self.max(gap)

    def barrier(self):
        self.max(0.0)
