"""Per-key TTL expiry (logical clock).

The paper's DPA pipeline has no notion of wall-clock expiry; TTL here is a
*store facade* feature layered over the versioned-read machinery: deadlines
live in a host-side sidecar keyed by u64 key, reads filter expired keys at
finalize time, and physical reclamation rides the existing delete ->
flush -> chain-compaction sweep (so the DPA-side wave kernels stay
untouched — expiry is a host policy, exactly like routing).

Time is a logical clock (``tick()``), not wall clock, so tests and
benchmarks are deterministic: a key written with ``ttl=K`` expires once
``now >= write_now + K``.

``freeze()`` snapshots (deadlines, now) for ``as_of`` reads: a key that was
live at epoch E stays visible through ``as_of=E`` even after it expires in
the present — expiry, like deletion, is a versioned event.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


@dataclass
class TTLTracker:
    """Host-side deadline sidecar: key -> absolute logical deadline."""

    deadlines: Dict[int, int] = field(default_factory=dict)
    now: int = 0

    def __bool__(self) -> bool:
        # empty trackers keep every read path on its zero-overhead fast lane
        return bool(self.deadlines)

    def tick(self, n: int = 1) -> int:
        """Advance the logical clock; returns the new now."""
        self.now += int(n)
        return self.now

    def note_put(self, keys: Iterable[int], ttl: Optional[int]) -> None:
        """Record deadlines for a PUT batch.  ``ttl=None`` means the write
        does not expire — it also CLEARS any deadline a previous write left
        on the key (an overwrite replaces the value *and* its policy)."""
        if ttl is None:
            if self.deadlines:
                for k in keys:
                    self.deadlines.pop(int(k), None)
            return
        deadline = self.now + int(ttl)
        for k in keys:
            self.deadlines[int(k)] = deadline

    def note_delete(self, keys: Iterable[int]) -> None:
        if not self.deadlines:
            return
        for k in keys:
            self.deadlines.pop(int(k), None)

    def is_expired_np(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized expiry mask for a u64 key array (any shape)."""
        flat = keys.reshape(-1)
        out = np.zeros(flat.shape[0], dtype=bool)
        dl = self.deadlines
        if dl:
            now = self.now
            for i, k in enumerate(flat.tolist()):
                d = dl.get(int(k))
                if d is not None and now >= d:
                    out[i] = True
        return out.reshape(keys.shape)

    def expired_keys(self) -> list:
        """Keys whose deadline has passed (candidates for the sweep)."""
        now = self.now
        return [k for k, d in self.deadlines.items() if now >= d]

    def prune(self, keys: Iterable[int]) -> None:
        """Forget deadlines after the sweep physically deleted the keys."""
        for k in keys:
            self.deadlines.pop(int(k), None)

    def freeze(self) -> Tuple[Dict[int, int], int]:
        """Immutable (deadlines, now) snapshot for an ``as_of`` epoch."""
        return dict(self.deadlines), self.now

    @staticmethod
    def expired_at(snap: Tuple[Dict[int, int], int], keys: np.ndarray) -> np.ndarray:
        """Expiry mask evaluated against a frozen snapshot."""
        deadlines, now = snap
        flat = keys.reshape(-1)
        out = np.zeros(flat.shape[0], dtype=bool)
        if deadlines:
            for i, k in enumerate(flat.tolist()):
                d = deadlines.get(int(k))
                if d is not None and now >= d:
                    out[i] = True
        return out.reshape(keys.shape)
