"""The process group of a data-parallel run (port of
gantron_tpu/parallel/distributed.py; reference: multiproc.py,
distributed.py:126-173).

One process drives one card, as in the reference. Every process runs the
same training command; ``initialize_multihost`` joins them into one
``torch.distributed`` group (NCCL by default, gloo for the CPU and for two
ranks that share one card), rank 0 is the chief. The JAX package gets its
gradient all-reduce from XLA once the batch is sharded; here the G and D
steps reduce their gradients themselves (``all_reduce_mean_``), and the
training BatchNorm reduces its sums (``all_reduce_sum``, differentiable).
Every collective is an ``all_reduce`` or a ``broadcast``: gloo on CUDA
tensors has no ``all_gather``.

Gradient convention: each rank's loss is its shard's mean, so the sum of
the ranks' losses is world-size times the global batch's loss. The backward
of ``all_reduce_sum`` sums the upstream gradients over ranks, so each
rank's parameter gradient is that of the summed loss along its own shard's
path; ``all_reduce_mean_`` sums those and divides by the world size, which
gives the gradient of the global batch's loss, as the JAX step on a
sharded batch computes it.
"""

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from gantron_tpu_torch.utils.device import derive_seed


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: str = "nccl", group_name: str = "",
                         timeout_s: float = 1800.0) -> int:
    """Joins this process to the training's process group and returns its
    rank (0 = chief).

    The group comes from, in this order: the explicit trio (the reference's
    ``dist_url``, ``world_size`` and ``rank``: ``coordinator_address`` as
    ``host:port`` or ``tcp://host:port``, rank 0 serving the rendezvous
    there, its keys under ``group_name``); the environment that ``torchrun``
    sets (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
    else none, a single-process run, which returns 0. Explicit arguments
    that do not form a group, or a configured environment that fails to,
    raise: swallowing the error would leave N trainings that each believe
    they are the chief."""
    if dist.is_initialized():
        return dist.get_rank()
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is not None or num_processes is not None:
        if coordinator_address is None or num_processes is None:
            raise ValueError("an explicit process group needs both "
                             "coordinator_address and num_processes")
        rank = 0 if process_id is None else int(process_id)
        world = int(num_processes)
        if not 0 <= rank < world:
            raise ValueError(f"process_id={rank} is outside "
                             f"[0, num_processes={world})")
        host, _, port = coordinator_address.split("://")[-1].rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"coordinator_address={coordinator_address!r} "
                             "is not host:port")
        store = dist.TCPStore(host, int(port), world, rank == 0, timeout)
        if group_name:
            store = dist.PrefixStore(group_name, store)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=timeout)
        return rank
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return dist.get_rank()
    return 0


def shutdown() -> None:
    """Leaves the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def in_group() -> bool:
    """True when this process belongs to a process group (of any size):
    the steps then reduce over it."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if in_group() else 0


def process_count() -> int:
    """The group's size; 1 without a group."""
    return dist.get_world_size() if in_group() else 1


def is_chief() -> bool:
    """True on the process that logs and writes checkpoints (the reference's
    rank 0)."""
    return process_index() == 0


def rank_seed(seed: int) -> int:
    """The seed of this process's random streams: ``seed`` itself in a
    single process, ``derive_seed(seed, rank)`` with more than one, so
    that each shard draws its own dropout masks and noise."""
    if process_count() == 1:
        return int(seed)
    return derive_seed(seed, process_index())


def barrier(name: str, timeout_s: float = 600.0) -> None:
    """Blocks until every process of the group reaches it; a no-op with
    fewer than two. On gloo a ``monitored_barrier``, which names the ranks
    that did not arrive within ``timeout_s``; on NCCL a barrier under the
    group's own timeout. ``name`` says which barrier failed."""
    if process_count() < 2:
        return
    try:
        if dist.get_backend() == "gloo":
            dist.monitored_barrier(
                timeout=datetime.timedelta(seconds=timeout_s))
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the upstream gradients over
    the group (module docstring)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the group, differentiable; ``x`` itself without a
    group."""
    return _AllReduceSum.apply(x) if in_group() else x


def _flat_groups(tensors):
    """``tensors`` grouped by dtype and device, each group flattened into
    one tensor: a collective a group. Yields (group, flat)."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        yield group, torch.cat([t.reshape(-1) for t in group])


def _unflatten_(group, flat):
    for t, part in zip(group, flat.split([t.numel() for t in group])):
        t.copy_(part.view_as(t))


@torch.no_grad()
def all_reduce_mean_(tensors):
    """Replaces each tensor by its mean over the group, in place: one
    ``all_reduce`` of a flat copy for each dtype and device (the step
    reduces after its backward has returned, so smaller buckets would
    overlap nothing). Returns ``tensors``; untouched without a group."""
    tensors = list(tensors)
    if not in_group():
        return tensors
    world = dist.get_world_size()
    for group, flat in _flat_groups(tensors):
        dist.all_reduce(flat)
        flat /= world
        _unflatten_(group, flat)
    return tensors


@torch.no_grad()
def broadcast_(tensors, src: int = 0):
    """Overwrites each tensor with the chief's (rank ``src``), in place, one
    ``broadcast`` for each dtype and device. Returns ``tensors``; untouched
    without a group."""
    tensors = list(tensors)
    if not in_group():
        return tensors
    for group, flat in _flat_groups(tensors):
        dist.broadcast(flat, src)
        _unflatten_(group, flat)
    return tensors
