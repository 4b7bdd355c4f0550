"""Sub-seeds: every draw of a run is keyed by the run's ``--seed`` and a
name, so one seed gives the same inputs whatever else the run draws."""
from __future__ import annotations

import hashlib


def derive(seed: int, *parts) -> int:
    """A 63-bit seed from ``seed`` (any whole number) and ``parts``."""
    text = ":".join(str(p) for p in (int(seed), *parts))
    digest = hashlib.sha256(text.encode()).digest()
    return int.from_bytes(digest[:8], "big") & (2 ** 63 - 1)
