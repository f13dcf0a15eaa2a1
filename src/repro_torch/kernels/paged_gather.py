"""Kernel B4: gather KV blocks by page-table slot list — the port of the JAX
package's ``kernels/paged_gather.py`` (``_gather_kernel`` / ``gather_pallas``).

The learned page table (a RANGE over the DPA-Store index) yields a
sequence's ordered slot list; the kernel copies the listed ``(bs, H, hd)``
blocks out of the ``(N, bs, H, hd)`` pool into a fresh contiguous
``(n, bs, H, hd)`` buffer for attention.  ``gather`` launches the CUDA kernel
(``csrc/paged_gather.cu``) for CUDA tensors and runs ``gather_plain`` for CPU
tensors.

Slots follow the reference's index rule (``pool[slots]`` in JAX): a negative
slot is first raised by N, then the result is clamped to ``[0, N-1]``.
Torch indexing raises on the CPU and is undefined on CUDA for such slots, so
both versions spell the rule out.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build


def clamp_slots(slots: torch.Tensor, n_pool: int) -> torch.Tensor:
    """The reference's slot rule, in int64: ``s + N`` where ``s < 0``, then
    clamped to ``[0, N-1]``."""
    s = slots.to(torch.int64)
    return torch.where(s < 0, s + n_pool, s).clamp(0, n_pool - 1)


def gather_plain(pool: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of the kernel."""
    return pool[clamp_slots(slots, pool.shape[0])]


def gather(pool: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    if slots.shape[0] == 0:
        return torch.zeros((0, *pool.shape[1:]), dtype=pool.dtype, device=pool.device)
    if not pool.is_cuda:
        return gather_plain(pool, slots)
    return gather_cuda(pool, slots)


def gather_cuda(pool: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Launch kernel B4; raises on operands the kernel does not take."""
    if pool.dim() != 4 or slots.dim() != 1:
        raise ValueError("expected pool (N, bs, H, hd) and slots (n,)")
    if slots.dtype != torch.int32:
        raise TypeError(f"slots must be int32, got {slots.dtype}")
    N = pool.shape[0]
    n = slots.shape[0]
    block_bytes = math.prod(pool.shape[1:]) * pool.element_size()
    if n and N == 0:
        raise ValueError("gather from an empty pool")
    if N >= 2**31 or block_bytes >= 2**31:
        raise ValueError("pool too large for the kernel's int arguments")
    if not (pool.is_cuda and pool.is_contiguous()):
        raise ValueError("the pool must be a contiguous CUDA tensor")
    dev = pool.device
    out = torch.empty((n, *pool.shape[1:]), dtype=pool.dtype, device=dev)
    if n == 0:  # nothing to launch
        return out
    fn = build.function("paged_gather", "dpa_paged_gather", n_ptrs=3, n_ints=3)
    err = fn(
        ctypes.c_void_p(pool.data_ptr()),  # bytes: any dtype
        *build.pointers([slots], dev),
        ctypes.c_void_p(out.data_ptr()),
        N,
        block_bytes,
        n,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    build.check(err, "paged_gather")
    build.launches["paged_gather"] += 1
    return out
