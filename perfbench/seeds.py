"""Seeds of a run's independent streams, all derived from ``--seed``."""

import hashlib


def derive(*parts) -> int:
    """A 63-bit seed from integers and strings, the same in every process."""
    digest = hashlib.blake2b(repr(tuple(parts)).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def derive32(*parts) -> int:
    """``derive`` cut to 32 bits, for ``numpy.random.RandomState``."""
    return derive(*parts) & 0xFFFFFFFF
