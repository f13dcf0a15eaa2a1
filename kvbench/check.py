"""The comparison that decides ``correct``: the reference replays every group
the run processed, in submission order, and the answers of the groups the
run kept are held against it row by row; after the window every
acknowledged write is read back through the entry and held against the
reference's final state.  Every comparison is exact, so every limit is 0.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .reference import SortedMap
from .traffic import Stream, pass_salt

LIMITS = {"get_wrong": 0, "scan_wrong": 0, "readback_wrong": 0}
STATUS_OK = 0


def written(stream: Stream, row: int, p: int) -> np.ndarray:
    """The values group ``row`` of pass ``p`` writes."""
    v = stream.write_vals[row]
    return v ^ pass_salt(p) if p else v


def get_wrong(vals, found, exp_vals, exp_found) -> int:
    return int(((np.asarray(found) != exp_found) | (np.asarray(vals) != exp_vals)).sum())


def scan_wrong(res, lens: np.ndarray, exp_keys, exp_vals, exp_counts) -> int:
    """Rows whose first ``len`` entries or whose count up to ``len`` differ."""
    limit = exp_keys.shape[1]
    keys = np.asarray(res.keys)[:, :limit]
    vals = np.asarray(res.vals)[:, :limit]
    mask = np.arange(limit)[None, :] < lens[:, None]
    bad = np.minimum(np.asarray(res.counts), lens) != np.minimum(exp_counts, lens)
    bad |= ((keys != exp_keys) & mask).any(axis=1)
    bad |= ((vals != exp_vals) & mask).any(axis=1)
    return int(bad.sum())


def judge(keys, vals, stream: Stream, log: List, scan_limit: int, readback) -> Dict[str, int]:
    """Replay ``log`` (the processed groups, in order) on a fresh reference
    over the loaded ``keys`` and ``vals``; return each compared number."""
    ref = SortedMap(keys, vals)
    G = stream.groups
    out = {}
    for e in log:
        row, p = e.g % G, e.g // G
        if e.results is not None:
            if "read" in e.results:
                ev, ef = ref.get(stream.read_keys[row])
                out["get_wrong"] = out.get("get_wrong", 0) + get_wrong(*e.results["read"], ev, ef)
            if "scan" in e.results:
                ek, evv, ec = ref.scan(stream.scan_starts[row], scan_limit)
                out["scan_wrong"] = out.get("scan_wrong", 0) + scan_wrong(
                    e.results["scan"], stream.scan_lens[row], ek, evv, ec
                )
        if e.status is not None:
            ack = np.asarray(e.status) == STATUS_OK
            ref.put(stream.write_keys[row][ack], written(stream, row, p)[ack])
    if readback is not None:
        rk, rv, rf = readback
        ev, ef = ref.get(rk)
        out["readback_wrong"] = get_wrong(rv, rf, ev, ef)
    return out


def acked_keys(stream: Stream, log: List) -> np.ndarray:
    """Distinct keys of every acknowledged write in ``log``."""
    G = stream.groups
    parts = [stream.write_keys[e.g % G][np.asarray(e.status) == STATUS_OK] for e in log if e.status is not None]
    return np.unique(np.concatenate(parts)) if parts else np.empty(0, dtype=np.uint64)
