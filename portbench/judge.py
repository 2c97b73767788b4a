"""The numbers that decide ``correct``: the widest gap between what the
timed path delivered and the plain reference, and the verdict on a run's
numbers against the cell's limits."""

from __future__ import annotations

from typing import Dict

import numpy as np

BIG = float(1 << 30)  # an answer of the wrong size says the wrong thing


def gap(got, want) -> float:
    """The largest absolute difference, as a float."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return BIG
    return float(np.abs(got - want).max()) if got.size else 0.0


def gap_beyond(got, want, allow, scale: float = 1.0) -> float:
    """The largest absolute difference of ``got`` [n, channels] and ``want``
    beyond each sample's ``allow`` [n] (times ``scale``), or 0 where every
    sample lies within it."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return BIG
    if not got.size:
        return 0.0
    excess = np.abs(got - want) - scale * np.asarray(allow, dtype=np.float64)[:, None]
    return max(0.0, float(excess.max()))


def side_gap(got, want, scale: float = 1.0, clip: float = np.inf, allow=0.0) -> float:
    """The largest gap of the two channels' difference, left minus right:
    ``got`` [n, 2] against ``scale`` times ``want`` [n, 2], over the samples
    where both of ``want``'s channels lie inside ``clip`` by more than the
    sample's ``allow`` [n] (a signal common to both channels that the check
    allows to differ could clip the one side and not the other)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return BIG
    margin = np.broadcast_to(np.asarray(allow, dtype=np.float64), want.shape[:1])[:, None]
    keep = (np.abs(want) + margin < clip).all(axis=1)
    d = (got[:, 0] - got[:, 1]) - scale * (want[:, 0] - want[:, 1])
    return float(np.abs(d[keep]).max()) if keep.any() else 0.0


def verdict(checks: Dict[str, dict]) -> bool:
    """``correct``: some number was compared, and each lies within its limit."""
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
