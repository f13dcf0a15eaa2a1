"""Kernel B4: gather KV blocks by page-table slot list — the port of the JAX
package's ``kernels/paged_gather.py`` (``_gather_kernel`` / ``gather_pallas``).

The learned page table (a RANGE over the DPA-Store index) yields a
sequence's ordered slot list; the kernel copies the listed ``(bs, H, hd)``
blocks out of the ``(N, bs, H, hd)`` pool into a fresh contiguous
``(n, bs, H, hd)`` buffer for attention.  One launch serves one pool
(``gather``, the counterpart of JAX's ``gather``) or the K and V pools of a
cache together (``gather_kv``).  Both launch the CUDA kernel
(``csrc/paged_gather.cu``) for CUDA tensors and run ``gather_plain`` /
``gather_kv_plain`` for CPU tensors.

Slots follow the reference's index rule (``pool[slots]`` in JAX): a negative
slot is first raised by N, then the result is clamped to ``[0, N-1]``.
Torch indexing raises on the CPU and is undefined on CUDA for such slots, so
both versions spell the rule out.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from . import build

# The kernel's launch plan (see csrc/paged_gather.cu).  H100: an SM has
# 228 KiB of shared memory, of which the runtime reserves 1 KiB per CTA, and
# runs at most 32 CTAs.
CHUNK = 16384  # bytes per item
WORD_THREADS = 256  # per CTA on the word path: a 16 KiB item is one batch
STAGES = 4  # shared-memory stages per CTA on the bulk path (csrc STAGES)
SMEM_PER_SM, SMEM_RESERVED, CTAS_PER_SM = 228 * 1024, 1024, 32


class GatherPlan(NamedTuple):
    bulk: bool  # bulk asynchronous copies, else 16-byte (or narrower) words
    chunk: int  # bytes per item, a multiple of 16
    chunks: int  # items per block
    items: int  # pools * n * chunks
    grid: int  # CTAs; item i is CTA i % grid's
    threads: int  # per CTA: one warp on the bulk path
    smem: int  # dynamic shared memory per CTA (the bulk path's ring)


def launch_plan(block_bytes: int, n: int, n_pools: int, sm_count: int, aligned: bool) -> GatherPlan:
    """Items, path and grid for ``n`` listed blocks of ``block_bytes`` in
    ``n_pools`` pools.  A block is cut into items of at most 16 KiB (a block
    smaller than that is one item): the attend's 59 slots of 32 KiB blocks
    are 236 items for K and V, over every SM.  Bulk copies when every address
    is 16-byte ``aligned`` and the whole list is in flight at once: a grid of
    CTAs that the SMs hold together (as many as their shared-memory rings
    allow), each streaming at most ``STAGES`` items.  Else the word path,
    one CTA per item."""
    chunk = min(CHUNK, -(-block_bytes // 16) * 16)
    chunks = -(-block_bytes // chunk)
    items = n_pools * n * chunks
    if aligned:
        smem = STAGES * chunk
        resident = sm_count * min(CTAS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))
        if items <= STAGES * resident:
            return GatherPlan(True, chunk, chunks, items, min(items, resident), 32, smem)
    return GatherPlan(False, chunk, chunks, items, items, WORD_THREADS, 0)


def clamp_slots(slots: torch.Tensor, n_pool: int) -> torch.Tensor:
    """The reference's slot rule, in int64: ``s + N`` where ``s < 0``, then
    clamped to ``[0, N-1]``."""
    s = slots.to(torch.int64)
    return torch.where(s < 0, s + n_pool, s).clamp(0, n_pool - 1)


def gather_plain(pool: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of the kernel."""
    return pool[clamp_slots(slots, pool.shape[0])]


def gather_kv_plain(
    pool_k: torch.Tensor, pool_v: torch.Tensor, slots: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch version of the kernel on a K and V pool pair."""
    return gather_plain(pool_k, slots), gather_plain(pool_v, slots)


def _empty(pool: torch.Tensor) -> torch.Tensor:
    return torch.zeros((0, *pool.shape[1:]), dtype=pool.dtype, device=pool.device)


def gather(pool: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    if slots.shape[0] == 0:
        return _empty(pool)
    if not pool.is_cuda:
        return gather_plain(pool, slots)
    return gather_cuda(pool, slots)


def gather_kv(
    pool_k: torch.Tensor, pool_v: torch.Tensor, slots: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    if slots.shape[0] == 0:
        return _empty(pool_k), _empty(pool_v)
    if not pool_k.is_cuda:
        return gather_kv_plain(pool_k, pool_v, slots)
    return gather_kv_cuda(pool_k, pool_v, slots)


def gather_cuda(pool: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Launch kernel B4 on one pool; raises on operands the kernel does not
    take."""
    return _launch((pool,), slots)[0]


def gather_kv_cuda(
    pool_k: torch.Tensor, pool_v: torch.Tensor, slots: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel B4 once on a K and V pool pair of one shape and dtype."""
    k, v = _launch((pool_k, pool_v), slots)
    return k, v


def _word_width(block_bytes: int, tensors) -> int:
    """Widest word (16, 8, 4, 2 or 1 bytes) that divides the block's byte
    count and every base address."""
    a = block_bytes
    for t in tensors:
        a |= t.data_ptr()
    w = 16
    while w > 1 and a % w:
        w //= 2
    return w


def _launch(pools, slots: torch.Tensor):
    pool = pools[0]
    if pool.dim() != 4 or slots.dim() != 1:
        raise ValueError("expected pools (N, bs, H, hd) and slots (n,)")
    if slots.dtype != torch.int32:
        raise TypeError(f"slots must be int32, got {slots.dtype}")
    for p in pools:
        if not (p.is_cuda and p.is_contiguous()):
            raise ValueError("the pools must be contiguous CUDA tensors")
        if p.shape != pool.shape or p.dtype != pool.dtype or p.device != pool.device:
            raise ValueError("the K and V pools must share shape, dtype and device")
    N = pool.shape[0]
    n = slots.shape[0]
    block_bytes = math.prod(pool.shape[1:]) * pool.element_size()
    if n and N == 0:
        raise ValueError("gather from an empty pool")
    if N >= 2**31 or block_bytes >= 2**31:
        raise ValueError("pool too large for the kernel's int arguments")
    dev = pool.device
    outs = [torch.empty((n, *pool.shape[1:]), dtype=pool.dtype, device=dev) for _ in pools]
    if n == 0:  # nothing to launch
        return outs
    width = _word_width(block_bytes, [*pools, *outs])
    plan = launch_plan(block_bytes, n, len(pools), build.sm_count(dev.index or 0), width == 16)
    if plan.items >= 2**31:
        raise ValueError("slot list too long for the kernel's int item count")
    fn = build.function("paged_gather", "dpa_paged_gather", n_ptrs=5, n_ints=10)
    err = fn(
        ctypes.c_void_p(pools[0].data_ptr()),  # bytes: any dtype
        ctypes.c_void_p(pools[-1].data_ptr()),
        *build.pointers([slots], dev),
        ctypes.c_void_p(outs[0].data_ptr()),
        ctypes.c_void_p(outs[-1].data_ptr()),
        len(pools),
        N,
        block_bytes,
        n,
        plan.chunk,
        plan.grid,
        plan.threads,
        plan.smem,
        int(plan.bulk),
        width,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    build.check(err, "paged_gather")
    build.launches["paged_gather"] += 1
    return outs
