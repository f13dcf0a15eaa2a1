"""Kernel B2: ONE payload-generic cache probe (Bloom + W-way buckets) — the
port of the JAX package's ``kernels/cache_probe.py``
(``_generic_probe_kernel`` / ``generic_probe_pallas``).

Both caches share the structure and differ only in the payload a bucket
entry carries: the GET hot-entry cache a 2-word value (``probe``, P=2), the
RANGE scan-anchor cache a 1-word leaf id (``anchor_probe``, P=1).
``generic_probe`` launches the CUDA kernel (``csrc/cache_probe.cu``) for
CUDA tensors and runs ``probe_plain`` for CPU tensors.  Outputs: ``hit``
(B,) bool and the payload (B, P), zeros on a miss.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..core import cacheset
from ..core.hotcache import SALT_BLOOM, SALT_BUCKET, CacheConfig
from ..core.scancache import SALT_SBLOOM, SALT_SBUCKET, ScanCacheConfig
from . import build


def probe_plain(
    bloom, bkey, bpay, bvalid, tid, khi, klo, *, bloom_bits, n_buckets, salts_bloom, salt_bucket
):
    """Plain-torch version of the kernel."""
    hit, (pay,) = cacheset.probe_set(
        bloom,
        bkey,
        bvalid,
        (bpay,),
        tid,
        khi,
        klo,
        n_buckets=n_buckets,
        bloom_bits=bloom_bits,
        bloom_salts=salts_bloom,
        bucket_salt=salt_bucket,
    )
    return hit, torch.where(hit[:, None], pay, 0)


def generic_probe(
    bloom,
    bkey,
    bpay,  # (T, NB, W, P) int32 payload words
    bvalid,
    tid,
    khi,
    klo,
    *,
    bloom_bits: int,
    n_buckets: int,
    salts_bloom: Sequence[int],
    salt_bucket: int,
):
    kw = dict(
        bloom_bits=bloom_bits, n_buckets=n_buckets, salts_bloom=salts_bloom, salt_bucket=salt_bucket
    )
    if not khi.is_cuda:
        return probe_plain(bloom, bkey, bpay, bvalid, tid, khi, klo, **kw)
    return probe_cuda(bloom, bkey, bpay, bvalid, tid, khi, klo, **kw)


def probe_cuda(
    bloom, bkey, bpay, bvalid, tid, khi, klo, *, bloom_bits, n_buckets, salts_bloom, salt_bucket
):
    if len(salts_bloom) != 3:
        raise ValueError("the probe kernel takes exactly three Bloom salts")
    T, NB, W, P = bpay.shape
    if bkey.shape != (T, NB, W, 2) or bvalid.shape != (T, NB, W) or NB != n_buckets:
        raise ValueError("cache arrays disagree on (threads, buckets, ways)")
    if bloom.shape != (T, bloom_bits // 32):
        raise ValueError("bloom must be (threads, bloom_bits / 32)")
    B = khi.shape[0]
    dev = khi.device
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    pay = torch.empty((B, P), dtype=torch.int32, device=dev)
    tid = tid.to(torch.int32)
    fn = build.function("cache_probe", "dpa_cache_probe", n_ptrs=9, n_ints=10)
    err = fn(
        *build.pointers([bloom, bkey, bpay, bvalid, tid, khi, klo, hit, pay], dev),
        B,
        bloom.shape[1],
        NB,
        W,
        P,
        bloom_bits,
        *[int(s) for s in salts_bloom],
        int(salt_bucket),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    build.check(err, "cache_probe")
    name = f"cache_probe_p{P}"
    build.launches[name] = build.launches.get(name, 0) + 1
    return hit, pay


def probe(cache, tid, khi, klo, *, cfg: CacheConfig):
    """GET hot-entry probe: the value-payload (P=2) instantiation.
    Returns (hit, vhi, vlo)."""
    hit, pay = generic_probe(
        cache.bloom,
        cache.bkey,
        cache.bval,  # (T, NB, W, 2): the u32 value limbs ARE the payload
        cache.bvalid,
        tid,
        khi,
        klo,
        bloom_bits=cfg.bloom_bits,
        n_buckets=cfg.n_buckets,
        salts_bloom=SALT_BLOOM,
        salt_bucket=SALT_BUCKET,
    )
    return hit, pay[:, 0], pay[:, 1]


def anchor_probe(cache, tid, khi, klo, *, cfg: ScanCacheConfig):
    """RANGE scan-anchor probe: the leaf-id-payload (P=1) instantiation.
    Returns (hit, leaf)."""
    hit, pay = generic_probe(
        cache.bloom,
        cache.bkey,
        cache.bleaf[..., None],  # (T, NB, W, 1) i32 leaf-id payload
        cache.bvalid,
        tid,
        khi,
        klo,
        bloom_bits=cfg.bloom_bits,
        n_buckets=cfg.n_buckets,
        salts_bloom=SALT_SBLOOM,
        salt_bucket=SALT_SBUCKET,
    )
    return hit, pay[:, 0]
