"""Hot-entry cache: per-thread Bloom filter + 4-way buckets (Sec 3.1.2 /
Figure 5).  PyTorch port of the JAX package's ``core/hotcache.py``.

Each of the 176 traverser threads owns a 256-bit, 3-hash Bloom filter and a
96-entry table of 4-way buckets.  Clients steer a key to a fixed thread.
Admission is hash-pseudo-random (no access tracking), and UPDATE / DELETE
invalidate entries; keys AND values are stored, so hash collisions are
detected exactly.  The probe itself is kernel B2 (``kernels/cache_probe``);
admit and invalidate are plain torch and update the state in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from . import cacheset
from .keys import limb_hash, u32

# hash salts (shared with clients)
SALT_STEER = 0  # request steering: thread = h % n_threads
SALT_BLOOM = (1, 2, 3)
SALT_BUCKET = 4
SALT_WAY = 5
SALT_ADMIT = 6


@dataclass(frozen=True)
class CacheConfig:
    n_threads: int = 176  # traverser threads (paper default)
    bloom_bits: int = 256  # fits the spare cache-line space
    n_buckets: int = 24  # 24 buckets x 4 ways = 96 entries/thread
    ways: int = 4  # KV pairs per cache-line bucket
    admit_shift: int = 2  # admit 1/2^shift of cacheable GET hits

    @property
    def entries_per_thread(self) -> int:
        return self.n_buckets * self.ways

    @property
    def total_entries(self) -> int:
        return self.n_threads * self.entries_per_thread


class CacheState(NamedTuple):
    bloom: torch.Tensor  # (T, bits/32) u32-in-i32
    bkey: torch.Tensor  # (T, NB, W, 2) u32-in-i32
    bval: torch.Tensor  # (T, NB, W, 2) u32-in-i32
    bvalid: torch.Tensor  # (T, NB, W) bool


def make_cache(cfg: CacheConfig, device) -> CacheState:
    T = cfg.n_threads
    shape = (T, cfg.n_buckets, cfg.ways)
    return CacheState(
        bloom=torch.zeros((T, cfg.bloom_bits // 32), dtype=torch.int32, device=device),
        bkey=torch.zeros(shape + (2,), dtype=torch.int32, device=device),
        bval=torch.zeros(shape + (2,), dtype=torch.int32, device=device),
        bvalid=torch.zeros(shape, dtype=torch.bool, device=device),
    )


def steer(khi, klo, n_threads: int) -> torch.Tensor:
    """Thread (shard) id a request is steered to — client-side hashing."""
    return (limb_hash(u32(khi), u32(klo), SALT_STEER) % n_threads).to(torch.int32)


def admit(
    cache: CacheState, tid, khi, klo, vhi, vlo, eligible, *, cfg: CacheConfig, wave: int = 0
) -> CacheState:
    """Randomly admit eligible entries in place (no access tracking — the
    paper's policy).  The coin is salted with the wave counter so the
    sampled subset rotates over time."""
    bloom, bkey, bvalid, (bval,) = cacheset.admit_set(
        cache.bloom,
        cache.bkey,
        cache.bvalid,
        (cache.bval,),
        (torch.stack([vhi, vlo], dim=-1),),
        tid,
        khi,
        klo,
        eligible,
        n_buckets=cfg.n_buckets,
        ways=cfg.ways,
        admit_shift=cfg.admit_shift,
        bloom_bits=cfg.bloom_bits,
        bloom_salts=SALT_BLOOM,
        bucket_salt=SALT_BUCKET,
        way_salt=SALT_WAY,
        admit_salt=SALT_ADMIT,
        wave=wave,
    )
    return CacheState(bloom=bloom, bkey=bkey, bval=bval, bvalid=bvalid)


def invalidate(cache: CacheState, tid, khi, klo, active, *, cfg: CacheConfig) -> CacheState:
    """UPDATE/DELETE consistency: clear a matching entry in place."""
    cacheset.invalidate_set(
        cache.bkey,
        cache.bvalid,
        tid,
        khi,
        klo,
        active,
        n_buckets=cfg.n_buckets,
        bucket_salt=SALT_BUCKET,
    )
    return cache
