"""Seeds of the benchmark's random streams, derived from ``--seed``."""
from __future__ import annotations

import hashlib


def derive(seed: int, *what) -> int:
    """A 63-bit seed for the stream named by ``what`` (any whole
    ``seed``, however large)."""
    key = ":".join(str(x) for x in (seed, *what)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1
