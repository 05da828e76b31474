"""Device selection: the port's entry points run on the card unless asked not to."""

import hashlib
import os

import torch
import torch.distributed as dist


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is
    no card, instead of quietly running on the CPU. ``"cuda"`` with no index
    is the process's own card in a data-parallel run: ``LOCAL_RANK`` when
    the launcher (torchrun) sets it, else the rank modulo the cards (the
    reference's ``set_device(rank % device_count)``), else the current
    one."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if device.type == "cuda" and device.index is None:
        if "LOCAL_RANK" in os.environ:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        elif dist.is_available() and dist.is_initialized():
            device = torch.device(
                "cuda", dist.get_rank() % torch.cuda.device_count())
    return device


def generator(device, seed: int) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (dropout, style and z draws
    take one explicitly, never the global generator)."""
    return torch.Generator(device=device).manual_seed(int(seed))


def draw(fn, shape, generator=None, **kw):
    """``fn(shape, generator=generator, **kw)`` for ``torch.rand`` or
    ``torch.randn``. With no generator it draws from the default one and
    leaves the argument out, since the overload that takes it needs a
    concrete shape and ``torch.export`` traces the batch as a symbol."""
    if generator is not None:
        kw["generator"] = generator
    return fn(shape, **kw)


def derive_seed(*ints) -> int:
    """A 63-bit generator seed from a tuple of integers, the same in every
    process (the port's counterpart of ``jax.random.fold_in``)."""
    digest = hashlib.blake2b(repr(tuple(int(i) for i in ints)).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1
