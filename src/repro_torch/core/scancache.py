"""Scan-anchor cache: per-thread Bloom filter + 4-way buckets mapping a
RANGE start key to the leaf where its descent bottomed out.  PyTorch port
of the JAX package's ``core/scancache.py``.

A hit lets ``RANGE(k_min, limit)`` skip the descent and start the bounded
leaf-chain walk at the cached anchor; the walk re-reads leaf rows and
insert buffers, so buffered writes since admission stay visible.  Entries
are invalidated by *leaf id* when a stitch cycle replaces their leaf.  The
probe is kernel B2 with a one-word payload (``kernels/cache_probe``);
admit and invalidation are plain torch and update the state in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from . import cacheset

# hash salts (disjoint from hotcache's; steering reuses hotcache.SALT_STEER
# so a key lands on the same thread for GET and RANGE)
SALT_SBLOOM = (21, 22, 23)
SALT_SBUCKET = 24
SALT_SWAY = 25
SALT_SADMIT = 26


@dataclass(frozen=True)
class ScanCacheConfig:
    n_threads: int = 176  # steering shards (paper's traverser grid)
    bloom_bits: int = 256
    n_buckets: int = 24  # 24 buckets x 4 ways = 96 anchors/thread
    ways: int = 4
    admit_shift: int = 0  # admit every missed scan (scans are rare + heavy)
    # pagination pre-warm: admit a truncated scan's cursor under
    # RANGE(last_key + 1)'s start key (store._admit_cursor_anchors)
    admit_cursors: bool = True

    @property
    def entries_per_thread(self) -> int:
        return self.n_buckets * self.ways

    @property
    def total_entries(self) -> int:
        return self.n_threads * self.entries_per_thread


class ScanCacheState(NamedTuple):
    bloom: torch.Tensor  # (T, bits/32) u32-in-i32
    bkey: torch.Tensor  # (T, NB, W, 2) u32-in-i32 — the exact scan start key
    bleaf: torch.Tensor  # (T, NB, W) i32 — anchor leaf id (-1 = empty)
    bepoch: torch.Tensor  # (T, NB, W) i32 — flush-cycle epoch at admit time
    bvalid: torch.Tensor  # (T, NB, W) bool


def make_cache(cfg: ScanCacheConfig, device) -> ScanCacheState:
    T = cfg.n_threads
    shape = (T, cfg.n_buckets, cfg.ways)
    return ScanCacheState(
        bloom=torch.zeros((T, cfg.bloom_bits // 32), dtype=torch.int32, device=device),
        bkey=torch.zeros(shape + (2,), dtype=torch.int32, device=device),
        bleaf=torch.full(shape, -1, dtype=torch.int32, device=device),
        bepoch=torch.zeros(shape, dtype=torch.int32, device=device),
        bvalid=torch.zeros(shape, dtype=torch.bool, device=device),
    )


def admit(
    cache: ScanCacheState,
    tid,
    khi,
    klo,
    leaf,
    eligible,
    *,
    cfg: ScanCacheConfig,
    wave: int = 0,
    epoch: int = 0,
) -> ScanCacheState:
    """Admit (k_min -> anchor leaf) entries in place, tagged with the
    flush-cycle counter at admit time."""
    bloom, bkey, bvalid, (bleaf, bepoch) = cacheset.admit_set(
        cache.bloom,
        cache.bkey,
        cache.bvalid,
        (cache.bleaf, cache.bepoch),
        (
            leaf.to(torch.int32),
            torch.tensor(epoch, dtype=torch.int32, device=leaf.device),
        ),
        tid,
        khi,
        klo,
        eligible,
        n_buckets=cfg.n_buckets,
        ways=cfg.ways,
        admit_shift=cfg.admit_shift,
        bloom_bits=cfg.bloom_bits,
        bloom_salts=SALT_SBLOOM,
        bucket_salt=SALT_SBUCKET,
        way_salt=SALT_SWAY,
        admit_salt=SALT_SADMIT,
        wave=wave,
    )
    return ScanCacheState(bloom=bloom, bkey=bkey, bleaf=bleaf, bepoch=bepoch, bvalid=bvalid)


def invalidate_leaves(
    cache: ScanCacheState, freed_leaves: torch.Tensor
) -> Tuple[ScanCacheState, int]:
    """Stitch-cycle consistency, in place: drop every anchor whose leaf id
    is in ``freed_leaves``.  Returns (cache, n_dropped)."""
    stale = torch.isin(cache.bleaf, freed_leaves) & cache.bvalid
    n = int(stale.sum())
    cache.bvalid.logical_and_(~stale)
    return cache, n
