"""Kernel B1: batched learned-index GET (descent + leaf probe + insert-buffer
merge) — the port of the JAX package's ``kernels/traverse.py``
(``_get_kernel`` / ``get_pallas``).

``get`` launches the CUDA kernel (``csrc/traverse.cu``) for CUDA tensors and
runs ``get_plain`` for CPU tensors.  Outputs: ``(vhi, vlo, found)`` with
int32-held u32 values; not-found rows carry 0.  ``get_plan`` picks the
kernel's shape for a wave: a warp per request for waves the card holds at
once that way, a thread per request for larger ones.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core import lookup
from . import build


def get_plain(tree, ib, khi, klo, *, depth: int, eps_inner: int, eps_leaf: int):
    """Plain-torch version of the kernel (same outputs, zeros when absent)."""
    vhi, vlo, found = lookup.get_batch(
        tree, ib, khi, klo, depth=depth, eps_inner=eps_inner, eps_leaf=eps_leaf
    )
    return torch.where(found, vhi, 0), torch.where(found, vlo, 0), found


def get(tree, ib, khi, klo, *, depth: int, eps_inner: int, eps_leaf: int):
    if not khi.is_cuda:
        return get_plain(tree, ib, khi, klo, depth=depth, eps_inner=eps_inner, eps_leaf=eps_leaf)
    return get_cuda(tree, ib, khi, klo, depth=depth, eps_inner=eps_inner, eps_leaf=eps_leaf)


# The kernel's launch plan (see csrc/traverse.cu).
WARP_CTA = 256  # threads per CTA of the warp-per-request kernel: 8 requests
THREAD_CTA = 128  # threads per CTA of the thread-per-request kernel
MAX_PASSES = 4  # passes of a warp over a window (csrc MAXP)


class GetPlan(NamedTuple):
    warp: bool  # one warp per request, else one thread per request
    threads: int  # per CTA
    grid: int  # CTAs: one request per warp (or thread)


def get_plan(B: int, eps_inner: int, eps_leaf: int, sm_count: int, ctas_per_sm) -> GetPlan:
    """Kernel shape of a GET wave of ``B`` requests.  ``ctas_per_sm(warp,
    threads)`` is the occupancy the card reports for that kernel shape.

    A warp per request issues each step's loads together, which shortens the
    chain a small wave waits on (the page table's 1-request waves); a large
    wave is bound by the leaf sectors it fetches, and a thread per request
    keeps all of it resident at once.  So: a warp per request when the whole
    wave fits on the card at once that way (and its windows, with the key
    before each, fit ``MAX_PASSES`` passes of the warp), else a thread."""
    if 2 * max(eps_inner, eps_leaf) + 3 <= 32 * MAX_PASSES:
        threads = min(WARP_CTA, 32 * B)
        per_cta = threads // 32
        if B <= sm_count * ctas_per_sm(True, threads) * per_cta:
            return GetPlan(True, threads, -(-B // per_cta))
    return GetPlan(False, THREAD_CTA, -(-B // THREAD_CTA))


@functools.lru_cache(maxsize=None)
def _ctas_per_sm(warp: bool, threads: int) -> int:
    fn = build.lib("traverse").dpa_get_ctas_per_sm
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    n = fn(int(warp), threads)
    build.check(max(0, -n), "the GET kernel's occupancy query")
    return n


def get_cuda(tree, ib, khi, klo, *, depth: int, eps_inner: int, eps_leaf: int):
    B = khi.shape[0]
    dev = khi.device
    vhi = torch.empty(B, dtype=torch.int32, device=dev)
    vlo = torch.empty(B, dtype=torch.int32, device=dev)
    found = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:  # nothing to launch
        return vhi, vlo, found
    ins = [
        tree.root,
        tree.node_seg_first,
        tree.node_seg_slope,
        tree.node_seg_count,
        tree.node_seg_slot,
        tree.pivot_keys,
        tree.pivot_child,
        tree.leaf_anchor,
        tree.leaf_slope,
        tree.leaf_count,
        tree.leaf_slot,
        tree.hbm_keys,
        tree.hbm_vals,
        ib.keys,
        ib.vals,
        ib.op,
        ib.count,
        khi,
        klo,
    ]
    ptrs = build.pointers(ins + [vhi, vlo, found], dev)
    ib_cap = ib.keys.shape[1]
    plan = get_plan(B, eps_inner, eps_leaf, build.sm_count(dev.index or 0), _ctas_per_sm)
    fn = build.function("traverse", "dpa_get", n_ptrs=22, n_ints=8)
    err = fn(
        *ptrs,
        B,
        depth,
        eps_inner,
        eps_leaf,
        ib_cap,
        int(plan.warp),
        plan.threads,
        plan.grid,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    build.check(err, "get")
    build.launches["get"] += 1
    return vhi, vlo, found
