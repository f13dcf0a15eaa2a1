"""Dispatch layer over the hand-written kernels — the port of the JAX
package's ``kernels/ops.py``.

Every op dispatches on the device of its tensors: CUDA tensors go to the
kernel (the wrapper launches it or raises), CPU tensors to the kernel's
plain-torch version.  The store calls these ops for GET, the cache probes
and RANGE, and the paged KV cache calls ``paged_gather_kv``, so on the card the
kernels carry both paths.  ``range_pack`` lays a RANGE wave's results out
for the host's one copy.

``range_scan_loop`` always runs kernel walk -> plain-torch insert-buffer
merge epilogue -> continuation loop, so the CPU tests exercise the same
epilogue and loop code the card runs.  Given the store's span table, it
times each round's merge epilogue as ``kv/range/merge``.
"""

from __future__ import annotations

import torch

from ..core import lookup
from ..core.hotcache import CacheConfig
from ..core.keys import limb_le, u32
from ..core.lookup import IB_DEL, IB_EMPTY, InsertBuffers
from ..core.scancache import ScanCacheConfig
from ..core.spans import SpanTable, span
from . import cache_probe as _probe
from . import paged_gather as _paged
from . import range_pack as _pack
from . import range_scan as _range
from . import traverse as _traverse


def get(tree, ib, khi, klo, *, depth: int, eps_inner: int, eps_leaf: int):
    """Batched GET (kernel B1): (vhi, vlo, found), zeros where absent."""
    return _traverse.get(
        tree, ib, khi, klo, depth=depth, eps_inner=eps_inner, eps_leaf=eps_leaf
    )


def cache_probe(cache, tid, khi, klo, *, cfg: CacheConfig):
    """Hot-entry cache probe (kernel B2, P=2): (hit, vhi, vlo)."""
    return _probe.probe(cache, tid, khi, klo, cfg=cfg)


def scan_anchor_probe(cache, tid, khi, klo, *, cfg: ScanCacheConfig):
    """Scan-anchor cache probe (kernel B2, P=1): (hit, leaf)."""
    return _probe.anchor_probe(cache, tid, khi, klo, cfg=cfg)


def paged_gather(pool, slots):
    """KV blocks ``pool[slots]`` (kernel B4): a fresh (n, bs, H, hd) buffer;
    zeros of shape (0, bs, H, hd) for an empty slot list."""
    return _paged.gather(pool, slots)


def paged_gather_kv(pool_k, pool_v, slots):
    """``paged_gather`` of a K and a V pool by one slot list, in one launch
    of kernel B4: (k, v)."""
    return _paged.gather_kv(pool_k, pool_v, slots)


def range_pack(rk, rv, valid, trunc, cursor, khi, klo, *, limit: int):
    """A RANGE wave's results in the host's layout (kernel B5): one uint8
    buffer of keys, values, counts, cursor keys and leaves and truncation
    flags at ``range_pack.layout``'s offsets, from the range loop's
    outputs, its ``cursor`` and the wave's start-key limbs."""
    return _pack.pack(rk, rv, valid, trunc, cursor.leaf, cursor.khi, cursor.klo, khi, klo, limit=limit)


def _empty_scan(khi, klo):
    B = khi.shape[0]
    dev = khi.device
    empty = torch.zeros((B, 0, 2), dtype=torch.int32, device=dev)
    return (
        empty,
        empty.clone(),
        torch.zeros((B, 0), dtype=torch.bool, device=dev),
        torch.zeros((B,), dtype=torch.bool, device=dev),
        lookup.ScanCursor(khi, klo, torch.full((B,), -1, dtype=torch.int32, device=dev)),
    )


def _round(tree, ib: InsertBuffers, start, khi, klo, *, limit: int, max_leaves: int, spans=None):
    """One bounded walk (kernel B3) + the insert-buffer merge epilogue."""
    cap = ib.keys.shape[1]
    # over-collect so buffered deletes can never starve the final cut
    kh, kl, vh, vl, cnt, visited, next_leaf = _range.walk(
        tree, start, khi, klo, limit=limit + max_leaves * cap, max_leaves=max_leaves
    )
    with span(SpanTable() if spans is None else spans, "kv/range/merge"):
        return _merge_ib_epilogue(ib, khi, klo, kh, kl, vh, vl, cnt, visited, next_leaf, limit=limit)


def range_scan(
    tree,
    ib: InsertBuffers,
    khi,
    klo,
    *,
    depth: int,
    eps_inner: int,
    limit: int,
    max_leaves: int = 4,
    start_leaf=None,
):
    """One-round RANGE: descent to the start leaf (skipped when an anchor /
    continuation ``start_leaf`` is given), kernel walk, merge epilogue.
    Returns (keys, vals, valid, truncated, cursor)."""
    if limit <= 0:
        return _empty_scan(khi, klo)
    if start_leaf is None:
        start_leaf = lookup.traverse(tree, khi, klo, depth=depth, eps_inner=eps_inner)
    return _round(tree, ib, start_leaf, khi, klo, limit=limit, max_leaves=max_leaves)


def range_scan_loop(
    tree,
    ib: InsertBuffers,
    khi,
    klo,
    *,
    depth: int,
    eps_inner: int,
    limit: int,
    max_leaves: int = 4,
    max_rounds: int = 0,
    start_leaf=None,
    ub_hi=None,
    ub_lo=None,
    spans=None,
):
    """Multi-round RANGE: the continuation of ``lookup.range_batch_loop``
    with each round's walk on kernel B3.  The walk's ``next_leaf`` output is
    the loop-carried cursor: each round feeds it back as the next round's
    start.  ``ub_hi``/``ub_lo`` are per-row owned-window upper-bound limbs
    (default: the KEY_MAX sentinel = no clip); ``spans`` is the store's
    span table.  Returns (keys, vals, valid, truncated, cursor, rounds)."""
    B = khi.shape[0]
    if limit <= 0 or B == 0:
        return (*_empty_scan(khi, klo), 0)
    sentinel = torch.full_like(khi, -1)  # 0xFFFFFFFF limbs
    ub_hi = sentinel if ub_hi is None else ub_hi
    ub_lo = sentinel if ub_lo is None else ub_lo
    if start_leaf is None:
        start_leaf = lookup.traverse(tree, khi, klo, depth=depth, eps_inner=eps_inner)

    def round_fn(s, h, l):
        return _round(tree, ib, s, h, l, limit=limit, max_leaves=max_leaves, spans=spans)

    return lookup.continuation_loop(
        round_fn,
        start_leaf,
        khi,
        klo,
        ub_hi,
        ub_lo,
        limit=limit,
        max_rounds=max_rounds,
        hard_cap=lookup.hard_cap_rounds(tree, max_leaves),
    )


def _merge_ib_epilogue(ib: InsertBuffers, khi, klo, kh, kl, vh, vl, cnt, visited, next_leaf, *, limit: int):
    """Merge the insert-buffer entries of the visited leaves into the walk's
    stitched results (newest wins, tombstones delete) and derive the
    continuation outputs: ``truncated`` (the chain continues at
    ``next_leaf`` AND the merged row under-filled ``limit``) and the resume
    cursor.  The walk's over-collection bound (``limit + max_leaves*ib_cap``)
    guarantees that an under-filled row emitted every survivor of its
    window, so the flag is exact."""
    B, L = kh.shape
    cap = ib.keys.shape[1]
    dev = kh.device

    # stitched part: priority 0
    s_valid = torch.arange(L, device=dev)[None, :] < cnt[:, None]

    # buffered part: (B, M, cap) gathered from the visited leaves
    leaf_safe = torch.clamp(visited, min=0).long()
    bk = u32(ib.keys[leaf_safe])  # (B, M, cap, 2)
    bv = ib.vals[leaf_safe]
    bo = ib.op[leaf_safe]
    pos = torch.arange(cap, device=dev)[None, None, :]
    b_valid = (visited >= 0)[:, :, None] & (pos < ib.count[leaf_safe][:, :, None]) & (bo != IB_EMPTY)
    # only keys >= k_min participate
    b_valid &= limb_le(u32(khi)[:, None, None], u32(klo)[:, None, None], bk[..., 0], bk[..., 1])
    b_prio = torch.arange(1, cap + 1, device=dev).expand(B, visited.shape[1], cap)

    keys_h = torch.cat([u32(kh), bk[..., 0].reshape(B, -1)], dim=1)
    keys_l = torch.cat([u32(kl), bk[..., 1].reshape(B, -1)], dim=1)
    vals_h = torch.cat([vh, bv[..., 0].reshape(B, -1)], dim=1)
    vals_l = torch.cat([vl, bv[..., 1].reshape(B, -1)], dim=1)
    valid = torch.cat([s_valid, b_valid.reshape(B, -1)], dim=1)
    prio = torch.cat([torch.zeros((B, L), dtype=torch.int64, device=dev), b_prio.reshape(B, -1)], 1)
    is_del = torch.cat(
        [torch.zeros((B, L), dtype=torch.bool, device=dev), (bo == IB_DEL).reshape(B, -1)], 1
    )

    keys_h = torch.where(valid, keys_h, 0xFFFFFFFF)
    keys_l = torch.where(valid, keys_l, 0xFFFFFFFF)
    order = lookup.sort_key_prio(keys_h, keys_l, prio)
    out_keys, out_vals, out_valid, n_found = lookup.compact_sorted(
        keys_h.gather(1, order),
        keys_l.gather(1, order),
        vals_h.gather(1, order),
        vals_l.gather(1, order),
        valid.gather(1, order),
        is_del.gather(1, order),
        limit,
    )
    truncated = (next_leaf >= 0) & (n_found < limit)
    cursor = lookup.make_cursor(khi, klo, out_keys, n_found, next_leaf, truncated)
    return out_keys, out_vals, out_valid, truncated, cursor
