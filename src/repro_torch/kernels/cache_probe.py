"""Kernel B2: ONE payload-generic cache probe (Bloom + W-way buckets) — the
port of the JAX package's ``kernels/cache_probe.py``
(``_generic_probe_kernel`` / ``generic_probe_pallas``).

Both caches share the structure and differ only in the payload a bucket
entry carries: the GET hot-entry cache a 2-word value (``probe``, P=2), the
RANGE scan-anchor cache a 1-word leaf id (``anchor_probe``, P=1).
``generic_probe`` launches the CUDA kernel (``csrc/cache_probe.cu``) for
CUDA tensors and runs ``probe_plain`` for CPU tensors.  Outputs: ``hit``
(B,) bool and the payload (B, P), zeros on a miss.  ``probe_plan`` picks
the kernel's shape for a wave: for the caches' 4-way layout, 16-byte loads
of the bucket, all issued at once for a small wave and only as far as the
Bloom test and the key compare need them for a large one; 32-bit loads for
any other layout.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

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


# The kernel's shapes (csrc/cache_probe.cu ``Design``) and its CTA size.
DESIGNS = {"loop": 0, "vector": 1, "gated": 2, "late": 3, "lean": 4, "generic": 5}
THREADS = 128
VECTOR_WAYS = 4  # "vector", "gated", "late" and "lean" read a 4-way bucket as 16-byte words


class ProbePlan(NamedTuple):
    design: str  # a key of DESIGNS
    threads: int  # per CTA, one request per thread
    grid: int  # CTAs


def serves(design: str, ways: int, P: int, aligned: bool) -> bool:
    """Whether ``design`` takes a cache of ``ways`` ways and ``P`` payload
    words; ``aligned``: ``vector_aligned`` holds for its arrays."""
    if design == "generic":
        return True
    if design == "loop":  # reads a key as one 8-byte word
        return aligned
    return aligned and ways == VECTOR_WAYS and P in (1, 2)


def shape(design: str, B: int, threads: int = THREADS) -> ProbePlan:
    """The grid of ``design`` for a wave of ``B`` requests."""
    return ProbePlan(design, threads, -(-B // threads))


def probe_plan(B: int, ways: int, P: int, aligned: bool, sm_count: int) -> ProbePlan:
    """Kernel shape of a probe wave of ``B`` requests on a card of
    ``sm_count`` SMs.  Where the layout allows 16-byte loads of the bucket
    (the caches' 4 ways, P = 1 or 2, ``aligned``): a wave of at most one
    CTA per SM waits on its chain of dependent loads, so every load is
    issued at once ("vector"); a larger wave waits on the loads its warps
    issue, so the bucket is read only for a Bloom-positive request, and the
    flags and payload only once a key matches ("lean").  Any other layout
    takes the generic 32-bit shape."""
    if not serves("vector", ways, P, aligned):
        return shape("generic", B)
    return shape("vector" if B <= sm_count * THREADS else "lean", B)


def vector_aligned(bkey, bpay, bvalid) -> bool:
    """The vector shapes read a bucket's keys and payloads as 16-byte words
    and its valid flags as one 4-byte word: each array's base must allow it
    (every bucket then starts at a multiple of those widths)."""
    return bkey.data_ptr() % 16 == 0 and bpay.data_ptr() % 16 == 0 and bvalid.data_ptr() % 4 == 0


def probe_cuda(
    bloom, bkey, bpay, bvalid, tid, khi, klo, *, bloom_bits, n_buckets, salts_bloom, salt_bucket
):
    """Launch the kernel in the shape ``probe_plan`` picks for the wave;
    raises on operands the kernel does not take."""
    if not khi.is_cuda:
        raise ValueError("the probe kernel takes CUDA tensors")
    W, P = bpay.shape[2:]
    aligned = vector_aligned(bkey, bpay, bvalid)
    plan = probe_plan(khi.shape[0], W, P, aligned, build.sm_count(khi.device.index or 0))
    return launch(
        bloom, bkey, bpay, bvalid, tid, khi, klo, plan=plan, bloom_bits=bloom_bits,
        n_buckets=n_buckets, salts_bloom=salts_bloom, salt_bucket=salt_bucket,
    )


def launch(
    bloom, bkey, bpay, bvalid, tid, khi, klo, *, plan: ProbePlan, bloom_bits, n_buckets, salts_bloom,
    salt_bucket,
):
    """Launch the kernel in the shape ``plan``."""
    if not khi.is_cuda:
        raise ValueError("the probe kernel takes CUDA tensors")
    if len(salts_bloom) != 3:
        raise ValueError("the probe kernel takes exactly three Bloom salts")
    T, NB, W, P = bpay.shape
    if bkey.shape != (T, NB, W, 2) or bvalid.shape != (T, NB, W) or NB != n_buckets:
        raise ValueError("cache arrays disagree on (threads, buckets, ways)")
    if bloom.shape != (T, bloom_bits // 32):
        raise ValueError("bloom must be (threads, bloom_bits / 32)")
    if bvalid.dtype != torch.bool:
        raise TypeError(f"bvalid must be bool, got {bvalid.dtype}")
    B = khi.shape[0]
    if khi.shape != (B,) or klo.shape != (B,) or tid.shape != (B,):
        raise ValueError("khi, klo and tid must be (B,)")
    if not serves(plan.design, W, P, vector_aligned(bkey, bpay, bvalid)):
        raise ValueError(f"the {plan.design} shape does not take W={W}, P={P} at these addresses")
    if plan.grid * plan.threads < B:
        raise ValueError("the plan's grid does not cover the wave")
    dev = khi.device
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    pay = torch.empty((B, P), dtype=torch.int32, device=dev)
    tid = tid.to(torch.int32)
    ptrs = build.pointers([bloom, bkey, bpay, bvalid, tid, khi, klo, hit, pay], dev)
    if B == 0:  # nothing to launch
        return hit, pay
    fn = build.function("cache_probe", "dpa_cache_probe", n_ptrs=9, n_ints=13)
    err = fn(
        *ptrs,
        B,
        bloom.shape[1],
        NB,
        W,
        P,
        bloom_bits,
        *[int(s) for s in salts_bloom],
        int(salt_bucket),
        DESIGNS[plan.design],
        plan.threads,
        plan.grid,
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
