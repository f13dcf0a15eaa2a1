"""Shared Bloom + N-way bucket machinery for the two NIC-side caches.

PyTorch port of the JAX package's ``core/cacheset.py``.  ``hotcache``
(point GET -> value) and ``scancache`` (RANGE start -> anchor leaf) are the
same Figure-5 structure with different payloads: a per-thread Bloom filter
over admitted keys plus a small set-associative bucket table, filled by a
wave-salted random admission coin and a hash-pseudo-random victim way.

Keys arrive as int32-held u32 limbs; hashes are computed on widened int64
values.  The caches are updated in place (the JAX package donates them).

Colliding admissions: two requests of one wave may pick the same
``(thread, bucket, way)``.  The reference writes key, payloads and valid bit
in separate scatters where the last duplicate wins on the CPU; on CUDA a
duplicate scatter has no defined winner, and could pair one request's key
with another's payload.  Here one winner per slot is picked explicitly —
the last request in wave order — and only the winners are scattered.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .keys import limb_eq, limb_hash, to_i32, u32


def bloom_hashes(kh, kl, bits: int, salts: Sequence[int]):
    """One bit index per salt for each (widened) key — the k hash functions."""
    return [limb_hash(kh, kl, s) % bits for s in salts]


def bucket_of(kh, kl, n_buckets: int, salt: int) -> torch.Tensor:
    return limb_hash(kh, kl, salt) % n_buckets


def bloom_may(bloom, tid, kh, kl, bits: int, salts: Sequence[int]) -> torch.Tensor:
    """Bloom test of each request against its steering thread's filter."""
    tid = tid.long()
    may = torch.ones_like(kh, dtype=torch.bool)
    for h in bloom_hashes(kh, kl, bits, salts):
        word = u32(bloom[tid, h // 32])
        may &= ((word >> (h % 32)) & 1) == 1
    return may


def probe_set(
    bloom: torch.Tensor,  # (T, bits/32) u32-in-i32
    bkey: torch.Tensor,  # (T, NB, W, 2) u32-in-i32
    bvalid: torch.Tensor,  # (T, NB, W) bool
    payloads: Tuple[torch.Tensor, ...],  # each (T, NB, W, ...)
    tid,
    khi,
    klo,
    *,
    n_buckets: int,
    bloom_bits: int,
    bloom_salts: Sequence[int],
    bucket_salt: int,
):
    """One probe wave.  Returns ``(hit, gathered_payloads)``; each gathered
    payload is the first matching way's entry (way 0's where ``~hit``)."""
    kh, kl = u32(khi), u32(klo)
    tid = tid.long()
    may = bloom_may(bloom, tid, kh, kl, bloom_bits, bloom_salts)
    bucket = bucket_of(kh, kl, n_buckets, bucket_salt)
    bk = u32(bkey[tid, bucket])  # (B, W, 2)
    eq = limb_eq(bk[:, :, 0], bk[:, :, 1], kh[:, None], kl[:, None]) & bvalid[tid, bucket]
    hit_way = torch.argmax(eq.to(torch.int32), dim=1)  # first matching way
    hit = may & eq.any(dim=1)
    gathered = tuple(p[tid, bucket, hit_way] for p in payloads)
    return hit, gathered


def invalidate_set(
    bkey, bvalid, tid, khi, klo, active, *, n_buckets: int, bucket_salt: int
) -> torch.Tensor:
    """Key-based UPDATE/DELETE consistency: clear the matching entry's valid
    bit in place (Bloom bits stay — they only cause false positives, which
    the exact key compare absorbs).  Returns ``bvalid``."""
    kh, kl = u32(khi), u32(klo)
    tid = tid.long()
    bucket = bucket_of(kh, kl, n_buckets, bucket_salt)
    bk = u32(bkey[tid, bucket])
    eq = limb_eq(bk[:, :, 0], bk[:, :, 1], kh[:, None], kl[:, None])
    eq &= bvalid[tid, bucket] & active[:, None]
    way = torch.argmax(eq.to(torch.int32), dim=1)
    hit = eq.any(dim=1)
    idx = torch.nonzero(hit).squeeze(1)  # every writer stores False: no race
    bvalid[tid[idx], bucket[idx], way[idx]] = False
    return bvalid


def last_writer(flat: torch.Tensor, take: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Mask of the requests that win their slot: among the ``take``
    requests aiming at the same ``flat`` slot, the last in wave order."""
    B = flat.shape[0]
    lane = torch.arange(B, device=flat.device)
    win = torch.full((n_slots,), -1, dtype=torch.int64, device=flat.device)
    win.scatter_reduce_(0, flat[take], lane[take], reduce="amax")
    return take & (win[flat] == lane)


def admit_set(
    bloom: torch.Tensor,  # (T, bits/32) u32-in-i32
    bkey: torch.Tensor,  # (T, NB, W, 2) u32-in-i32
    bvalid: torch.Tensor,  # (T, NB, W) bool
    payloads: Tuple[torch.Tensor, ...],  # each (T, NB, W, ...)
    updates: Tuple[torch.Tensor, ...],  # matching per-request values to store
    tid,
    khi,
    klo,
    eligible,  # (B,) bool
    *,
    n_buckets: int,
    ways: int,
    admit_shift: int,
    bloom_bits: int,
    bloom_salts: Sequence[int],
    bucket_salt: int,
    way_salt: int,
    admit_salt: int,
    wave: int,
):
    """One admit wave, in place.  Admission is wave-salted hash-random
    (1/2^admit_shift of eligible requests).  Fill takes the first invalid
    way, else evicts a hash-pseudo-random victim; colliding admissions keep
    the last request in wave order (see module docstring).  Returns
    ``(bloom, bkey, bvalid, payloads)``."""
    kh, kl = u32(khi), u32(klo)
    tid = tid.long()
    wave_salt = ((int(wave) & 0xFFFFFFFF) * 0x9E3779B9) & 0xFFFFFFFF
    rnd = limb_hash(kh, kl, admit_salt) ^ wave_salt
    rnd = (rnd * 0x7FEB352D) & 0xFFFFFFFF  # rnd < 2^32, product < 2^63
    rnd = rnd ^ (rnd >> 13)
    take = eligible & (((rnd >> 7) % (1 << admit_shift)) == 0)
    bucket = bucket_of(kh, kl, n_buckets, bucket_salt)
    ways_valid = bvalid[tid, bucket]  # (B, W)
    has_free = ~ways_valid.all(dim=1)
    first_free = torch.argmin(ways_valid.to(torch.int32), dim=1)
    victim = limb_hash(kh, kl, way_salt) % ways
    way = torch.where(has_free, first_free, victim)
    T, NB, W = bvalid.shape
    win = last_writer((tid * NB + bucket) * W + way, take, T * NB * W)
    idx = torch.nonzero(win).squeeze(1)
    t, b, w = tid[idx], bucket[idx], way[idx]
    bkey[t, b, w] = torch.stack([khi[idx], klo[idx]], dim=-1)
    for p, upd in zip(payloads, updates):
        p[t, b, w] = upd[idx] if upd.dim() else upd
    bvalid[t, b, w] = True
    # Bloom OR: every taken request sets its bits (duplicates write the same
    # 1, so no winner is needed); the reference's one-hot planes, in place
    n_words = bloom.shape[1]
    planes = torch.zeros((T, n_words, 32), dtype=torch.int64, device=bloom.device)
    tk = torch.nonzero(take).squeeze(1)
    for h in bloom_hashes(kh[tk], kl[tk], bloom_bits, bloom_salts):
        planes[tid[tk], h // 32, h % 32] = 1
    new_bits = (planes << torch.arange(32, device=bloom.device)).sum(dim=-1)
    bloom.copy_(to_i32(u32(bloom) | new_bits))
    return bloom, bkey, bvalid, payloads
