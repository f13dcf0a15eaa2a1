"""Kernel B3: the RANGE leaf-chain walk — the port of the JAX package's
``kernels/range_scan.py`` (``_range_kernel`` / ``range_pallas``).

Per lane, walk ``leaf_next`` from the start leaf (-1 = dead lane) for exactly
``max_leaves`` steps and append the stitched entries >= k_min in order, up to
``limit`` columns.  ``walk`` launches the CUDA kernel (``csrc/range_scan.cu``)
for CUDA tensors and runs ``walk_plain`` for CPU tensors.  Outputs: keys_hi,
keys_lo, vals_hi, vals_lo (B, limit) int32-held u32, zero past the count;
n (B,); visited (B, max_leaves) (-1 once the chain ended); next (B,), the
first unwalked leaf (-1 = chain exhausted).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.keys import limb_le, u32
from ..core.tree import SEG_CAP
from . import build


def walk_plain(tree, start, khi, klo, *, limit: int, max_leaves: int):
    """Plain-torch version of the kernel (same outputs and padding)."""
    assert limit >= 1, "0-width outputs: the callers guard limit=0"
    B = start.shape[0]
    dev = start.device
    outs = [torch.zeros((B, limit + 1), dtype=torch.int32, device=dev) for _ in range(4)]
    kh, kl = u32(khi)[:, None], u32(klo)[:, None]
    pos = torch.arange(SEG_CAP, device=dev)[None, :]
    cnt = torch.zeros(B, dtype=torch.int64, device=dev)
    leaf = start.long()
    visited = []
    for _ in range(max_leaves):
        alive = leaf >= 0
        safe = torch.clamp(leaf, min=0)
        visited.append(torch.where(alive, leaf, -1))
        slot = tree.leaf_slot[safe].long()
        rk = tree.hbm_keys[slot]  # (B, 128, 2)
        rv = tree.hbm_vals[slot]
        ge = limb_le(kh, kl, u32(rk[..., 0]), u32(rk[..., 1]))
        mask = ge & (pos < tree.leaf_count[safe][:, None]) & alive[:, None]
        tgt = cnt[:, None] + torch.cumsum(mask.to(torch.int64), dim=1) - 1
        put = mask & (tgt < limit)
        tgt = torch.where(put, tgt, limit)  # scratch column, dropped below
        for out, src in zip(outs, (rk[..., 0], rk[..., 1], rv[..., 0], rv[..., 1])):
            out.scatter_(1, tgt, torch.where(put, src, 0))
        cnt = torch.clamp(cnt + mask.sum(dim=1), max=limit)
        leaf = torch.where(alive, tree.leaf_next[safe].long(), -1)
    okh, okl, ovh, ovl = (o[:, :limit].contiguous() for o in outs)
    return (
        okh,
        okl,
        ovh,
        ovl,
        cnt.to(torch.int32),
        torch.stack(visited, dim=1).to(torch.int32),
        leaf.to(torch.int32),
    )


def walk(tree, start, khi, klo, *, limit: int, max_leaves: int):
    if not khi.is_cuda:
        return walk_plain(tree, start, khi, klo, limit=limit, max_leaves=max_leaves)
    return walk_cuda(tree, start, khi, klo, limit=limit, max_leaves=max_leaves)


def walk_cuda(tree, start, khi, klo, *, limit: int, max_leaves: int):
    if limit < 1 or max_leaves < 1:
        raise ValueError("the walk needs limit >= 1 and max_leaves >= 1")
    B = start.shape[0]
    dev = start.device
    outs = [torch.empty((B, limit), dtype=torch.int32, device=dev) for _ in range(4)]
    n = torch.empty(B, dtype=torch.int32, device=dev)
    visited = torch.empty((B, max_leaves), dtype=torch.int32, device=dev)
    nxt = torch.empty(B, dtype=torch.int32, device=dev)
    start = start.to(torch.int32).contiguous()
    fn = build.function("range_scan", "dpa_range_walk", n_ptrs=15, n_ints=3)
    err = fn(
        *build.pointers(
            [
                tree.leaf_next,
                tree.leaf_count,
                tree.leaf_slot,
                tree.hbm_keys,
                tree.hbm_vals,
                start,
                khi,
                klo,
                *outs,
                n,
                visited,
                nxt,
            ],
            dev,
        ),
        B,
        limit,
        max_leaves,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    build.check(err, "range_walk")
    build.launches["range_walk"] += 1
    return (*outs, n, visited, nxt)
