"""The data-parallel layout (port of gantron_tpu/parallel/mesh.py).

The JAX package lays a 1-D ``Mesh`` over its devices, shards the batch's
rows over it and replicates the state. The port's mesh is the process
group, one card a process: every process builds the SAME global batch (the
same loaders and seeds, padded to the same buckets), takes its contiguous
rows (``shard_batch``) and holds a replica of the state that starts as the
chief's (``shard_state``). The losses are plain means over padded tensors
and the discriminator scores windows of the padded length, so equal shards
of one padded batch give the global batch's losses as the mean of the
ranks' (parallel/distributed.py).
"""

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from gantron_tpu_torch.parallel.distributed import (broadcast_,
                                                    process_count,
                                                    process_index)


class Mesh(NamedTuple):
    """The data axis: ``size`` processes, this one at ``rank``."""

    shape: tuple
    size: int
    rank: int


def make_mesh(shape: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh of ``shape`` (None: one device a process of the group),
    which must hold exactly one device a process: more would need a group
    that does not exist, and a process never trains a larger mesh alone."""
    world = process_count()
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n != world:
        raise ValueError(
            f"mesh shape {shape} has {n} devices but the process group has "
            f"{world} process(es), one device each; launch {n} processes "
            "(torchrun --nproc_per_node, or --n_gpus/--rank) or set "
            f"mesh_shape=[{world}]")
    return Mesh(shape, n, process_index())


def pad_batch_rows(batch, multiple: int):
    """Repeat-pads every array of ``batch`` (a tuple or NamedTuple of numpy
    arrays or tensors, rows first) with copies of its last row, to a row
    count divisible by ``multiple``. Validation keeps remainder batches
    (drop_last=False); the training loader drops them and never pads."""
    rows = batch[0].shape[0]
    pad_n = (-rows) % multiple
    if pad_n == 0:
        return batch

    def pad(x):
        if torch.is_tensor(x):
            return torch.cat([x, x[-1:].expand(pad_n, *x.shape[1:])])
        x = np.asarray(x)
        return np.concatenate([x, np.repeat(x[-1:], pad_n, axis=0)], axis=0)

    return type(batch)(*(pad(x) for x in batch))


def shard_rows(x, rank: int, world: int):
    """Rows ``[rank * n, (rank + 1) * n)`` of ``x``, ``n = rows / world``."""
    rows = x.shape[0]
    if rows % world:
        raise ValueError(f"{rows} rows do not split over {world} processes")
    n = rows // world
    return x[rank * n:(rank + 1) * n]


def shard_batch(batch, rank: int, world: int):
    """This process's contiguous rows of every array of the global
    ``batch``, as ``make_array_from_process_local_data`` takes them."""
    if world == 1:
        return batch
    return type(batch)(*(shard_rows(x, rank, world) for x in batch))


def state_tensors(state):
    """Every tensor of a ``GANTrainState`` that a replica must share:
    both models' parameters and buffers and both Adam states' moments."""
    return ([t.data for t in state.g_model.state_dict().values()]
            + [t.data for t in state.d_model.state_dict().values()]
            + state.g_opt_state.mu + state.g_opt_state.nu
            + state.d_opt_state.mu + state.d_opt_state.nu)


def shard_state(state, *numbers):
    """Replicates the chief's ``state`` on every process, in place: every
    parameter, buffer and Adam moment, the step and update counts, and
    ``numbers`` (the loop's iteration and learning rates), which it returns
    as the chief's. The state's random generators stay each process's own
    (the loop reseeds them from the iteration and the rank).
    A single process returns ``numbers`` unchanged."""
    if process_count() == 1:
        return numbers
    broadcast_(state_tensors(state))
    device = state.g_model.device
    counts = torch.tensor([state.step, state.g_opt_state.count,
                           state.d_opt_state.count, *numbers],
                          dtype=torch.float64, device=device)
    broadcast_([counts])
    step, g_count, d_count, *numbers = counts.tolist()
    state.step = int(step)
    state.g_opt_state = state.g_opt_state._replace(count=int(g_count))
    state.d_opt_state = state.d_opt_state._replace(count=int(d_count))
    return tuple(numbers)
