"""Piecewise linear approximation (PLA) training — the host-side model builder.

The paper uses the greedy PGM algorithm [10] to fit segments with a hard error
bound eps over sorted keys (Sec 3.1.1).  Training runs on the *host* (the
paper's patcher threads run on the x86 host; here: numpy), never on the
accelerator, so plain float64 is the faithful tool.

Algorithm: feasible-slope-window greedy.  A segment anchored at its first key
``x0`` (local rank 0) keeps the interval of slopes ``[smin, smax]`` such that
``|a*(x_i - x0) - i| <= eps`` for every point admitted so far; a point that
empties the interval starts the next segment.  This guarantees the bound by
construction; a post-verification pass (exact integer ranks) guards the two
float64 rounding corner cases and splits if ever violated.

Error note: slopes satisfy ``a ~ count/span`` so the f64 representation error
of a delta contributes at most ``count * 2^-53`` positions — negligible even
for segments spanning the full 64-bit key space (see core/keys.py).

Fixed-point reference: the DPAs have no FPU, so the paper evaluates
``p = a*k + b`` in fixed point, widening to 128 bit.  :func:`predict_fixed`
reproduces that scheme exactly with Python integers (arbitrary precision ==
the DPA's 128-bit temporaries) and is asserted equivalent to the f32 device
path in tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

FIXED_SHIFT = 62  # fractional bits of the fixed-point slope (fits i128 temporaries)


@dataclass(frozen=True)
class Segment:
    """One PLA segment over ``keys[start:start+count]`` (sorted u64)."""

    start: int  # index of first covered key in the training array
    count: int  # number of keys covered
    anchor: np.uint64  # first covered key; prediction input is (k - anchor)
    slope: float  # local rank ~= slope * (k - anchor)

    @property
    def slope_fixed(self) -> "Tuple[int, int]":
        """Paper-faithful fixed-point slope as (mantissa, shift).

        Slopes span ~2^-64..2^7, so a fixed global shift starves tiny slopes
        of mantissa bits; the 128-bit widening the paper describes implies a
        per-segment scaling.  We give every slope ~40 significant bits and
        keep the product ``mantissa * delta`` within 128 bits:
        ``a*d*2^shift <= 128 * 2^110 < 2^127``.
        """
        if self.slope <= 0.0:
            return 0, FIXED_SHIFT
        shift = int(min(110, max(0, 40 - np.floor(np.log2(self.slope)))))
        return int(round(self.slope * (1 << shift))), shift


def _fit_one(keys: np.ndarray, start: int, eps: float, max_count: int) -> Segment:
    """Greedily extend one segment from ``start``; returns the fitted segment."""
    n = keys.shape[0]
    x0 = keys[start]
    hi_lim = min(n - start, max_count)
    if hi_lim == 1:
        return Segment(start, 1, np.uint64(x0), 0.0)
    dx = (keys[start + 1 : start + hi_lim] - x0).astype(np.float64)  # exact < 2^53
    dy = np.arange(1, hi_lim, dtype=np.float64)
    upper = (dy + eps) / dx
    lower = (dy - eps) / dx
    cum_up = np.minimum.accumulate(upper)
    cum_lo = np.maximum.accumulate(lower)
    feasible = cum_lo <= cum_up
    if feasible.all():
        count = hi_lim
    else:
        count = int(np.argmin(feasible)) + 1  # first infeasible point excluded
    if count == 1:
        return Segment(start, 1, np.uint64(x0), 0.0)
    j = count - 2  # last admitted delta index
    slope = 0.5 * (cum_lo[j] + cum_up[j])
    return Segment(start, count, np.uint64(x0), float(slope))


def _verify(keys: np.ndarray, seg: Segment, eps: float) -> bool:
    d = (keys[seg.start : seg.start + seg.count] - seg.anchor).astype(np.float64)
    pred = seg.slope * d
    ranks = np.arange(seg.count, dtype=np.float64)
    return bool(np.all(np.abs(pred - ranks) <= eps + 1e-6))


def fit(keys: np.ndarray, eps: float, max_count: int = 128) -> List[Segment]:
    """Segment sorted unique u64 ``keys`` with error bound ``eps``.

    Every returned segment satisfies ``|slope*(k - anchor) - local_rank| <= eps``
    for each covered key (verified; a failing segment is bisected — this is a
    float-rounding safety net that essentially never fires).
    """
    keys = np.asarray(keys, dtype=np.uint64)
    assert keys.ndim == 1
    if keys.size == 0:
        return []
    segs: List[Segment] = []
    start = 0
    n = keys.size
    while start < n:
        seg = _fit_one(keys, start, eps, max_count)
        while not _verify(keys, seg, eps):  # pragma: no cover - float safety net
            half = max(1, seg.count // 2)
            seg = _fit_one(keys, start, eps, half)
            if seg.count <= 1:
                break
        segs.append(seg)
        start += seg.count
    return segs


# ---------------------------------------------------------------------------
# partition boundary fitting (range-sharded tier)
# ---------------------------------------------------------------------------


def fit_boundaries(keys: np.ndarray, n_parts: int) -> np.ndarray:
    """Quantile partition boundaries for the range-sharded distributed tier.

    The learned-index idea applied at cluster granularity: a hash partition
    destroys key order (so RANGE must broadcast), while cutting the *empirical
    key CDF* at uniform quantiles — the zero-parameter limit of the PLA models
    this module fits — gives every partition an equal share of the loaded keys
    AND keeps each partition a contiguous key slice, so a scan only ever
    touches the owner and its immediate successors.

    Returns the sorted ``(n_parts - 1,)`` u64 array ``b`` of partition *start*
    keys: partition ``p`` owns ``[b[p-1], b[p])`` with implicit ``b[-1] = 0``
    and ``b[n_parts-1] = 2^64``.  Route with
    ``np.searchsorted(b, key, side="right")`` (bit-identical to the device
    boundary search in ``repro.distributed.rangeshard``).

    With fewer loaded keys than partitions the empirical CDF is meaningless;
    fall back to a uniform key-space split (the uninformative prior) so every
    key still has exactly one owner.  Duplicate quantile values (possible only
    for non-unique inputs) simply leave the intermediate partitions empty.
    """
    assert n_parts >= 1
    if n_parts == 1:
        return np.zeros((0,), dtype=np.uint64)
    keys = np.sort(np.asarray(keys, dtype=np.uint64))
    if keys.size < n_parts:
        step = (1 << 64) // n_parts
        return (np.arange(1, n_parts, dtype=np.uint64) * np.uint64(step)).astype(
            np.uint64
        )
    ranks = (np.arange(1, n_parts, dtype=np.int64) * keys.size) // n_parts
    return keys[ranks].astype(np.uint64)


def refit_boundaries(
    sample: np.ndarray,
    n_parts: int,
    old: Optional[np.ndarray] = None,
    damping: float = 1.0,
) -> np.ndarray:
    """Incremental boundary refit for *online* rebalancing.

    ``fit_boundaries`` is the load-time fit; under a sustained skewed insert
    storm the loaded-key quantiles stop describing the live distribution and
    the edge partitions fatten.  This function refits against a *streaming
    key sample* (``distributed.rebalance.ReservoirSample``) and, when ``old``
    boundaries are given, moves each boundary only ``damping`` of the way
    toward its fresh sample quantile — the same damped-update play every
    online quantile sketch uses to keep a noisy small sample from thrashing
    the partition map (each boundary move is a slice *migration*, so a
    spurious move costs real stitch traffic).

    The result is always sorted non-decreasing (equal adjacent boundaries
    denote an empty partition, exactly as in ``fit_boundaries``); the
    interpolation quantizes ``damping`` to a rational (denominator 2^10)
    and runs in exact Python-int arithmetic, so boundary deltas wider than
    the f64 mantissa (u64 key spans routinely are) never pick up float
    rounding.
    """
    assert 0.0 < damping <= 1.0, damping
    target = fit_boundaries(np.asarray(sample, dtype=np.uint64), n_parts)
    if old is None or damping >= 1.0:
        return target
    old = np.asarray(old, dtype=np.uint64)
    assert old.shape == target.shape, (old.shape, target.shape)
    num = max(1, round(damping * 1024))
    out = np.empty_like(target)
    for i in range(target.size):
        o, t = int(old[i]), int(target[i])
        out[i] = np.uint64(o + (t - o) * num // 1024)
    return np.maximum.accumulate(out)


# ---------------------------------------------------------------------------
# prediction — float reference and paper-faithful fixed point
# ---------------------------------------------------------------------------


def predict_float(seg: Segment, keys: np.ndarray) -> np.ndarray:
    """f64 host prediction of local ranks (clipped to the segment)."""
    d = (np.asarray(keys, dtype=np.uint64) - seg.anchor).astype(np.float64)
    return np.clip(seg.slope * d, 0.0, seg.count - 1)


def predict_fixed(seg: Segment, keys: np.ndarray) -> np.ndarray:
    """Paper-faithful fixed-point prediction (128-bit temporaries).

    ``p = (mantissa * (k - anchor)) >> shift`` with a per-segment shift.
    Python ints model the DPA's widened 128-bit arithmetic exactly.
    """
    a, shift = seg.slope_fixed
    out = np.empty(len(keys), dtype=np.int64)
    anchor = int(seg.anchor)
    for i, k in enumerate(np.asarray(keys, dtype=np.uint64)):
        d = int(k) - anchor
        out[i] = (a * d) >> shift
    return np.clip(out, 0, seg.count - 1)


def max_abs_error(keys: np.ndarray, segs: List[Segment]) -> float:
    """Largest |prediction - true local rank| over all segments (diagnostic)."""
    worst = 0.0
    for seg in segs:
        ks = keys[seg.start : seg.start + seg.count]
        pred = predict_float(seg, ks)
        ranks = np.arange(seg.count, dtype=np.float64)
        worst = max(worst, float(np.max(np.abs(pred - ranks))))
    return worst
