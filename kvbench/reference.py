"""The plain reference: an ordered map of u64 keys to u64 values in NumPy.

It imports nothing of the program.  The benchmark hands it the loaded keys
and values and the operation stream that it hands the program, in
submission order, and it works the store's state out again from them:

* ``put`` applies a batch of writes in order (a key written twice in one
  batch keeps its last value); a key not yet present is inserted.
* ``get`` answers (value, found) per key; an absent key reads (0, False).
* ``scan`` answers the first ``limit`` entries at or above each start key,
  ascending, with zeros past each row's count.

The loaded keys stay in one sorted array whose values are updated in place;
inserted keys live in a small sorted overlay beside it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def last_of_each(keys: np.ndarray, vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Distinct ``keys`` (sorted) with the value of each one's last write."""
    rk = keys[::-1]
    uk, first_in_reversed = np.unique(rk, return_index=True)
    return uk, vals[::-1][first_in_reversed]


class SortedMap:
    def __init__(self, keys: np.ndarray, vals: np.ndarray):
        keys = np.asarray(keys, dtype=np.uint64)
        if keys.size > 1 and not (keys[1:] > keys[:-1]).all():
            raise ValueError("the loaded keys must be sorted and distinct")
        self.keys = keys
        self.vals = np.array(vals, dtype=np.uint64)  # a copy: updated in place
        self.ov_keys = np.empty(0, dtype=np.uint64)
        self.ov_vals = np.empty(0, dtype=np.uint64)

    def _find(self, sorted_keys: np.ndarray, ks: np.ndarray):
        if sorted_keys.size == 0:
            return np.zeros(ks.size, dtype=np.int64), np.zeros(ks.size, dtype=bool)
        pos = np.searchsorted(sorted_keys, ks)
        pos_c = np.minimum(pos, sorted_keys.size - 1)
        return pos_c, sorted_keys[pos_c] == ks

    def put(self, keys: np.ndarray, vals: np.ndarray) -> None:
        uk, uv = last_of_each(np.asarray(keys, dtype=np.uint64), np.asarray(vals, dtype=np.uint64))
        pos, hit = self._find(self.keys, uk)
        self.vals[pos[hit]] = uv[hit]
        nk, nv = uk[~hit], uv[~hit]
        if nk.size == 0:
            return
        opos, ohit = self._find(self.ov_keys, nk)
        self.ov_vals[opos[ohit]] = nv[ohit]
        add_k, add_v = nk[~ohit], nv[~ohit]
        if add_k.size:
            k = np.concatenate([self.ov_keys, add_k])
            v = np.concatenate([self.ov_vals, add_v])
            order = np.argsort(k, kind="stable")
            self.ov_keys, self.ov_vals = k[order], v[order]

    def get(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        ks = np.asarray(keys, dtype=np.uint64)
        pos, hit = self._find(self.keys, ks)
        vals = np.where(hit, self.vals[pos], np.uint64(0))
        if self.ov_keys.size:
            opos, ohit = self._find(self.ov_keys, ks)
            vals = np.where(ohit, self.ov_vals[opos], vals)
            hit = hit | ohit
        return vals, hit

    def scan(self, starts: np.ndarray, limit: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(keys (n, limit), vals (n, limit), counts (n,)) of each start."""
        s = np.asarray(starts, dtype=np.uint64)
        k, v, live = _window(self.keys, self.vals, s, limit)
        if self.ov_keys.size:
            ok, ov, olive = _window(self.ov_keys, self.ov_vals, s, limit)
            k = np.concatenate([k, ok], axis=1)
            v = np.concatenate([v, ov], axis=1)
            live = np.concatenate([live, olive], axis=1)
            order = np.argsort(np.where(live, k, U64_MAX), axis=1, kind="stable")[:, :limit]
            k = np.take_along_axis(k, order, axis=1)
            v = np.take_along_axis(v, order, axis=1)
            live = np.take_along_axis(live, order, axis=1)
        zero = np.uint64(0)
        return np.where(live, k, zero), np.where(live, v, zero), live.sum(axis=1)

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        k = np.concatenate([self.keys, self.ov_keys])
        v = np.concatenate([self.vals, self.ov_vals])
        order = np.argsort(k, kind="stable")
        return k[order], v[order]


U64_MAX = np.uint64(2**64 - 1)


def _window(keys: np.ndarray, vals: np.ndarray, starts: np.ndarray, limit: int):
    """The first ``limit`` rows of sorted ``keys`` at or above each start."""
    j = np.searchsorted(keys, starts)
    cols = j[:, None] + np.arange(limit)[None, :]
    live = cols < keys.size
    cols = np.minimum(cols, max(keys.size - 1, 0))
    if keys.size == 0:
        z = np.zeros(cols.shape, dtype=np.uint64)
        return z, z, live
    return keys[cols], vals[cols], live
