"""GAN training in G/G/D cycles, data parallel: one process a card, each a
rank of the program's own process group (``perfbench.group``), as users of
the reference's ``--n_gpus`` (or ``torchrun``) recipe train.

The cell's ``params`` are ``train_cycle``'s, ``batch`` being the global
batch: every rank draws the seed's pool batches and G-step styles at the
global batch's size, as ``train_cycle`` does, and takes its rows of them,
rank r rows [r n, (r + 1) n) of n = batch / ranks. Each rank's dropout
generator is seeded from the seed and its rank. The ranks run each cycle
in step; the program reduces the BatchNorm statistics, the gradients and
the metrics over them.

The check (rank 0's): ``train_cycle``'s, against a reference that steps on
the whole global batch and draws each rank's rows of every dropout from
that rank's stream, in the ranks' order of draws; the window's held cycle
is decided by rank 0's clock and its starting state carries every rank's
dropout state. Besides, ``rank_param_gap``: the largest difference of any
parameter or BatchNorm statistic of G and D on any rank from rank 0's once
the window has closed, exchanged over the group (exactly 0 when the ranks
step alike).
"""

from perfbench.traffic import train_cycle


class Traffic(train_cycle.Traffic):
    def __init__(self, cell, cfg, seed, device, trace, seconds, group):
        super().__init__(cell, cfg, seed, device, trace, seconds)
        self.group, self.ranks = group, group.world
        if cell["params"]["batch"] % group.world:
            raise ValueError(f"a global batch of {cell['params']['batch']} "
                             f"rows does not split over {group.world} ranks")
        self.rank_gap = None

    def _local(self, x):
        n = x.shape[0] // self.group.world
        return x[self.group.rank * n:(self.group.rank + 1) * n]

    def _dropout_seed(self):
        return train_cycle.dropout_seed(self.seed, self.group.rank)

    def _holds(self, now):
        return self.group.chief_says(super()._holds(now))

    def _start(self):
        start = super()._start()
        start["dropout"] = self.group.gather(start["dropout"])
        return start

    def release(self):
        """Reads ``rank_param_gap`` (an exchange every rank takes part in),
        then lets go of the training state."""
        t = self.trainer
        self.rank_gap = self.group.gap_from_chief(
            [x for _, x in t.g_state() + t.d_state()])
        super().release()

    def check(self):
        """Rank 0: ``train_cycle``'s check over the ranks and
        ``rank_param_gap``; the other ranks hold only the gap."""
        gaps = super().check() if self.group.rank == 0 else {}
        gaps["rank_param_gap"] = self.rank_gap
        return gaps
