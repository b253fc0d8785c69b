"""Protocol-aware message dedup for hash-to-curve.

Port of ``lighthouse_tpu/blsrt.py`` ``DedupPlan``/``identity_plan``/
``dedup_plan``. Mainnet attestation batches repeat each committee message
many times, so hashing runs once per DISTINCT message and the [S]-row grid
is rebuilt with one gather. Row i of the output equals the hash of
``distinct[index[i]]``: bit-identical to hashing row i directly, because
hash-to-curve is a pure function of the message bytes.
"""

from __future__ import annotations

import numpy as np


class DedupPlan:
    """Gather plan: the distinct messages plus an int32 row -> distinct index."""

    __slots__ = ("distinct", "index", "enabled")

    def __init__(self, distinct, index, enabled: bool):
        self.distinct = distinct          # list[bytes], first-seen order
        self.index = index                # np.int32[n] rows -> distinct
        self.enabled = enabled            # False for the identity plan

    @property
    def n(self) -> int:
        return len(self.index)


def identity_plan(messages) -> DedupPlan:
    """Every row is its own 'distinct' entry: the gather is the identity."""
    msgs = [bytes(m) for m in messages]
    return DedupPlan(msgs, np.arange(len(msgs), dtype=np.int32), False)


def dedup_plan(messages) -> DedupPlan:
    """The dedup plan for one batch: distinct messages in first-seen order."""
    distinct: list[bytes] = []
    first: dict[bytes, int] = {}
    index = np.empty(len(messages), np.int32)
    for i, m in enumerate(messages):
        key = bytes(m)
        j = first.get(key)
        if j is None:
            j = first[key] = len(distinct)
            distinct.append(key)
        index[i] = j
    return DedupPlan(distinct, index, True)
