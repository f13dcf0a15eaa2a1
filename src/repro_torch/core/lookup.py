"""Plain-torch batched traversal of the learned index (reference path).

PyTorch port of the JAX package's ``core/lookup.py`` (the descent, the leaf
and insert-buffer probes, GET, the bounded RANGE walk and its continuation
loop).  Every function is batched over a request wave and returns the
reference's outputs bit for bit: keys and values as int32-held u32 limbs,
ids as int32.  Internally the u32 limbs are widened to int64 before any
compare or subtraction (see ``keys.py``).

The CUDA kernels in ``repro_torch.kernels`` compute the same functions; the
``ops`` layer sends CUDA tensors to them and CPU tensors here.  The
point-in-time reads at the end of the file (``as_of``) have no kernel in
either package: they run as plain torch on whatever device holds the tree.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .keys import floor_to_i32_saturating, limb_eq, limb_le, limb_sub_to_f32, to_i32, u32
from .tree import DeviceTree

# insert-buffer op codes
IB_EMPTY = 0
IB_PUT = 1  # INSERT or UPDATE (newest wins)
IB_DEL = 2  # tombstone

PAD32 = -1  # 0xFFFFFFFF as an int32 bit pattern: the key padding sentinel


class InsertBuffers(NamedTuple):
    """Per-leaf insert buffers (Sec 3.1).  Updated in place by the write
    path and the stitch CLEAR (the JAX package donates them instead)."""

    keys: torch.Tensor  # (Nl, cap, 2) u32-in-i32
    vals: torch.Tensor  # (Nl, cap, 2) u32-in-i32
    op: torch.Tensor  # (Nl, cap) i32
    count: torch.Tensor  # (Nl,) i32


def make_insert_buffers(n_leaves: int, cap: int, device) -> InsertBuffers:
    return InsertBuffers(
        keys=torch.zeros((n_leaves, cap, 2), dtype=torch.int32, device=device),
        vals=torch.zeros((n_leaves, cap, 2), dtype=torch.int32, device=device),
        op=torch.full((n_leaves, cap), IB_EMPTY, dtype=torch.int32, device=device),
        count=torch.zeros((n_leaves,), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# inner-node routing (kh/kl below are widened int64 limbs)
# ---------------------------------------------------------------------------


def _predict(slope, a_hi, a_lo, kh, kl):
    """Clamped-below PLA prediction of a local rank (f32)."""
    below = ~limb_le(a_hi, a_lo, kh, kl)  # key < anchor
    delta = limb_sub_to_f32(kh, kl, a_hi, a_lo)
    return torch.where(below, torch.zeros_like(delta), slope * delta)


def _window_rank(pool_keys, slot, count, pred, eps, kh, kl):
    """Index of the last key <= k inside the eps window around ``pred``
    (-1 when the key precedes the window), and the window base."""
    w = 2 * eps + 2
    lo = torch.clamp(floor_to_i32_saturating(pred) - eps, min=0)
    lo = torch.minimum(lo, torch.clamp(count - w, min=0))
    idx = lo[:, None] + torch.arange(w, device=lo.device)[None, :]  # (B, w)
    wk = u32(pool_keys[slot[:, None], idx])  # (B, w, 2)
    le = limb_le(wk[:, :, 0], wk[:, :, 1], kh[:, None], kl[:, None])
    in_range = idx < count[:, None]
    c = (le & in_range).sum(dim=1)
    return lo + c - 1, lo


def _route(tree: DeviceTree, node, kh, kl, eps: int):
    node = node.long()
    sf = u32(tree.node_seg_first[node])  # (B, 7, 2)
    le = limb_le(sf[:, :, 0], sf[:, :, 1], kh[:, None], kl[:, None])
    # padded segments hold KEY_MAX -> never <= a real key; segment 0 is the
    # floor for keys below the node's range.
    seg = le[:, 1:].sum(dim=1)
    bidx = torch.arange(node.shape[0], device=node.device)
    pred = _predict(
        tree.node_seg_slope[node, seg], sf[bidx, seg, 0], sf[bidx, seg, 1], kh, kl
    )
    count = tree.node_seg_count[node, seg].long()
    slot = tree.node_seg_slot[node, seg].long()
    rank, _ = _window_rank(tree.pivot_keys, slot, count, pred, eps, kh, kl)
    return tree.pivot_child[slot, torch.clamp(rank, min=0)]


def route_one_level(tree: DeviceTree, node, khi, klo, eps: int) -> torch.Tensor:
    """One inner-node descent step for a wave: node (B,) -> child (B,) i32."""
    return _route(tree, node, u32(khi), u32(klo), eps)


def traverse(tree: DeviceTree, khi, klo, *, depth: int, eps_inner: int) -> torch.Tensor:
    """Descend the learned index: request keys (B,) -> leaf ids (B,) i32."""
    kh, kl = u32(khi), u32(klo)
    node = tree.root.to(torch.int32).expand(khi.shape[0])
    for _ in range(depth - 1):
        node = _route(tree, node, kh, kl, eps_inner)
    return node.contiguous()


# ---------------------------------------------------------------------------
# leaf access
# ---------------------------------------------------------------------------


def leaf_search(
    tree: DeviceTree, leaf, khi, klo, eps_leaf: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Search the leaf's key row.  Returns (rank, found, vhi, vlo); rank =
    index of the last key <= k within the leaf (-1 if none)."""
    kh, kl = u32(khi), u32(klo)
    leaf = leaf.long()
    slot = tree.leaf_slot[leaf].long()
    count = tree.leaf_count[leaf].long()
    anchor = u32(tree.leaf_anchor[leaf])
    pred = _predict(tree.leaf_slope[leaf], anchor[:, 0], anchor[:, 1], kh, kl)
    rank, _ = _window_rank(tree.hbm_keys, slot, count, pred, eps_leaf, kh, kl)
    safe = torch.clamp(rank, min=0)
    kk = u32(tree.hbm_keys[slot, safe])
    found = (rank >= 0) & limb_eq(kk[:, 0], kk[:, 1], kh, kl)
    vv = tree.hbm_vals[slot, safe]
    return rank, found, vv[:, 0], vv[:, 1]


def ib_search(ib: InsertBuffers, leaf, khi, klo):
    """Scan the leaf's insert buffer, newest entry wins.  Returns (present,
    deleted, vhi, vlo): ``present`` = the newest entry is a live PUT,
    ``deleted`` = it is a tombstone."""
    leaf = leaf.long()
    bk = u32(ib.keys[leaf])  # (B, cap, 2)
    bop = ib.op[leaf]
    cnt = ib.count[leaf]
    cap = bk.shape[1]
    pos = torch.arange(cap, device=leaf.device)[None, :]
    match = (
        limb_eq(bk[:, :, 0], bk[:, :, 1], u32(khi)[:, None], u32(klo)[:, None])
        & (pos < cnt[:, None])
        & (bop != IB_EMPTY)
    )
    newest = torch.where(match, pos, -1).max(dim=1).values  # (B,)
    has = newest >= 0
    safe = torch.clamp(newest, min=0)
    op = bop.gather(1, safe[:, None])[:, 0]
    v = ib.vals[leaf, safe]
    present = has & (op == IB_PUT)
    deleted = has & (op == IB_DEL)
    return present, deleted, v[:, 0], v[:, 1]


def get_batch(
    tree: DeviceTree, ib: InsertBuffers, khi, klo, *, depth: int, eps_inner: int, eps_leaf: int
):
    """Full GET path (sans hot cache): traverse -> insert buffer (newest
    wins) -> leaf probe.  Not-found rows carry leaf residue, as in the
    reference; the kernel's plain version zeroes them."""
    leaf = traverse(tree, khi, klo, depth=depth, eps_inner=eps_inner)
    ib_present, ib_deleted, ib_vhi, ib_vlo = ib_search(ib, leaf, khi, klo)
    _, tree_found, t_vhi, t_vlo = leaf_search(tree, leaf, khi, klo, eps_leaf)
    found = ib_present | (tree_found & ~ib_deleted)
    vhi = torch.where(ib_present, ib_vhi, t_vhi)
    vlo = torch.where(ib_present, ib_vlo, t_vlo)
    return vhi, vlo, found


# ---------------------------------------------------------------------------
# range scan: merge leaf rows + insert buffers in key order along leaf_next
# ---------------------------------------------------------------------------


class ScanCursor(NamedTuple):
    """Resume point of a bounded RANGE walk — and, representationally, a
    scan anchor: (key limbs, leaf id).  For truncated rows ``leaf`` is the
    first unwalked leaf and ``khi/klo`` the last key emitted (the original
    ``k_min`` when nothing was); for complete rows ``leaf`` is -1."""

    khi: torch.Tensor  # (B,) u32-in-i32
    klo: torch.Tensor  # (B,) u32-in-i32
    leaf: torch.Tensor  # (B,) i32, -1 = complete


def make_cursor(khi, klo, out_keys, n_found, cont_leaf, truncated) -> ScanCursor:
    """Resume cursor from a scan's outputs: last emitted key (falling back
    to k_min for empty rows) + the first unwalked leaf."""
    last = torch.clamp(n_found.long() - 1, min=0)[:, None]
    last_kh = out_keys[..., 0].gather(1, last)[:, 0]
    last_kl = out_keys[..., 1].gather(1, last)[:, 0]
    has = n_found > 0
    return ScanCursor(
        khi=torch.where(has, last_kh, khi),
        klo=torch.where(has, last_kl, klo),
        leaf=torch.where(truncated, cont_leaf, -1).to(torch.int32),
    )


def sort_key_prio(kh, kl, prio):
    """Row-wise order of ``jnp.lexsort((-prio, kl, kh))``: key ascending,
    priority descending among equal keys, original position last.  Two
    stable sorts: by ``-prio``, then by the key folded into one order-
    preserving int64 (``(hi - 2^31) * 2^32 + lo``)."""
    order = torch.sort(-prio, dim=1, stable=True).indices
    key = (kh - 2**31) * 4294967296 + kl
    order2 = torch.sort(key.gather(1, order), dim=1, stable=True).indices
    return order.gather(1, order2)


def compact_sorted(kh, kl, vh, vl, live, is_del, limit: int):
    """Shared tail of the RANGE merge: on rows sorted by (key, newest
    first), keep the first occurrence of each live key unless it is a
    tombstone, and compact the survivors into ``limit`` output columns.
    ``kh``/``kl`` are widened keys, ``vh``/``vl`` int32 values.  Returns
    (keys (B,limit,2), vals, valid (B,limit), n_found (B,))."""
    B = kh.shape[0]
    dev = kh.device
    first = torch.ones_like(live)
    first[:, 1:] = (kh[:, 1:] != kh[:, :-1]) | (kl[:, 1:] != kl[:, :-1])
    keep = live & first & ~is_del
    target = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    in_out = keep & (target < limit)
    tgt = torch.where(in_out, target, limit)  # overflow -> scratch column
    out_k = torch.full((B, limit + 1, 2), PAD32, dtype=torch.int32, device=dev)
    out_v = torch.zeros((B, limit + 1, 2), dtype=torch.int32, device=dev)
    keys = torch.stack([kh, kl], dim=-1)
    keys = torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32)
    vals = torch.stack([vh, vl], dim=-1)
    m = in_out[..., None]
    t2 = tgt[..., None].expand(-1, -1, 2)
    out_k.scatter_(1, t2, torch.where(m, keys, PAD32))
    out_v.scatter_(1, t2, torch.where(m, vals, 0))
    n_found = torch.clamp(keep.sum(dim=1), max=limit)
    valid = torch.arange(limit, device=dev)[None, :] < n_found[:, None]
    return out_k[:, :limit].contiguous(), out_v[:, :limit].contiguous(), valid, n_found


def range_batch_from(
    tree: DeviceTree, ib: InsertBuffers, start_leaf, khi, klo, *, limit: int, max_leaves: int = 4
):
    """RANGE(k_min, limit) for a wave, starting the leaf-chain walk at
    ``start_leaf`` (-1 = dead lane).  Returns (keys (B,limit,2), vals,
    valid (B,limit), truncated (B,), cursor) — the reference's contract:
    ``truncated`` is True iff the chain continues past the walked window
    AND fewer than ``limit`` entries were returned."""
    assert limit >= 1, "limit=0 is guarded by the callers"
    cap = ib.keys.shape[1]
    B = khi.shape[0]
    dev = khi.device
    prio_ib = torch.arange(1, cap + 1, device=dev).expand(B, cap)

    parts = []
    leaf = start_leaf.long()
    alive = start_leaf >= 0
    for _ in range(max_leaves):
        safe = torch.clamp(leaf, min=0)
        slot = tree.leaf_slot[safe].long()
        lk = tree.hbm_keys[slot]  # (B,128,2)
        lv = tree.hbm_vals[slot]
        width = lk.shape[1]
        lvalid = (
            torch.arange(width, device=dev)[None, :] < tree.leaf_count[safe][:, None]
        ) & alive[:, None]
        bvalid = (
            (torch.arange(cap, device=dev)[None, :] < ib.count[safe][:, None])
            & (ib.op[safe] != IB_EMPTY)
            & alive[:, None]
        )
        parts.append(
            (
                torch.cat([lk, ib.keys[safe]], dim=1),
                torch.cat([lv, ib.vals[safe]], dim=1),
                torch.cat([lvalid, bvalid], dim=1),
                torch.cat([torch.zeros((B, width), dtype=torch.int64, device=dev), prio_ib], 1),
                torch.cat(
                    [torch.zeros((B, width), dtype=torch.bool, device=dev), ib.op[safe] == IB_DEL],
                    1,
                ),
            )
        )
        nxt = tree.leaf_next[safe].long()
        alive = alive & (nxt >= 0)
        leaf = nxt
    # after the walk: ``alive`` <=> an unwalked successor exists (= ``leaf``)

    keys = u32(torch.cat([p[0] for p in parts], dim=1))
    vals = torch.cat([p[1] for p in parts], dim=1)
    valid = torch.cat([p[2] for p in parts], dim=1)
    prio = torch.cat([p[3] for p in parts], dim=1)
    is_del = torch.cat([p[4] for p in parts], dim=1)

    kh, kl = keys[..., 0], keys[..., 1]
    ge_min = limb_le(u32(khi)[:, None], u32(klo)[:, None], kh, kl)
    live = valid & ge_min
    kh = torch.where(live, kh, 0xFFFFFFFF)
    kl = torch.where(live, kl, 0xFFFFFFFF)
    order = sort_key_prio(kh, kl, prio)
    out_keys, out_vals, out_valid, n_found = compact_sorted(
        kh.gather(1, order),
        kl.gather(1, order),
        vals[..., 0].gather(1, order),
        vals[..., 1].gather(1, order),
        live.gather(1, order),
        is_del.gather(1, order),
        limit,
    )
    truncated = alive & (n_found < limit)
    cursor = make_cursor(khi, klo, out_keys, n_found, leaf, truncated)
    return out_keys, out_vals, out_valid, truncated, cursor


# ---------------------------------------------------------------------------
# continuation loop: re-walk only truncated lanes from their cursor
# ---------------------------------------------------------------------------


def continuation_loop(
    round_fn,
    start_leaf,
    khi,
    klo,
    ub_hi,
    ub_lo,
    *,
    limit: int,
    max_rounds: int = 0,
    hard_cap: int,
    advance_kmin: bool = False,
):
    """Drive ``round_fn`` (one bounded walk: ``(start, khi, klo) -> (keys,
    vals, valid, truncated, cursor)``) until every lane hit ``limit``,
    exhausted its chain, or ran into its owned window ``[.., ub)``.

    The reference runs this as a ``jax.lax.while_loop`` on the device.
    Here it is a Python round loop: the first round always runs, and every
    later round costs one host sync (``active.any()``).  The round count,
    the accumulators and the cursor equal the reference's exactly.

    ``advance_kmin`` (versioned scans): after each round, a lane that
    emitted keys moves its ``k_min`` to its last emitted key + 1, with the
    carry from the low limb into the high one.  A versioned round reads
    each walked leaf through its resolved ancestor, whose key range can
    reach below the walked window; the advance keeps rounds disjoint.  The
    final cursor still falls back to the original ``k_min``.

    ``max_rounds=0`` loops until quiescence (bounded by ``hard_cap``);
    ``max_rounds>=1`` stops early and reports the leftover lanes
    ``truncated`` with a live resume cursor.  Returns (keys (B,limit,2),
    vals, valid, truncated, cursor, rounds)."""
    B = khi.shape[0]
    dev = khi.device
    cap_rounds = hard_cap if max_rounds <= 0 else min(max_rounds, hard_cap)
    cols = torch.arange(limit, device=dev)[None, :]
    ubh, ubl = u32(ub_hi)[:, None], u32(ub_lo)[:, None]
    acc_k = torch.full((B, limit + 1, 2), PAD32, dtype=torch.int32, device=dev)
    acc_v = torch.zeros((B, limit + 1, 2), dtype=torch.int32, device=dev)
    acc_n = torch.zeros((B,), dtype=torch.int64, device=dev)
    cur = start_leaf.to(torch.int32)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    rhi, rlo = khi, klo  # each round's k_min (moves only with advance_kmin)
    rounds = 0
    while B and rounds < cap_rounds and (rounds == 0 or bool(active.any())):
        start = torch.where(active, cur, -1)
        rk, rv, rvalid, rtrunc, cursor = round_fn(start, rhi, rlo)
        # owned-window clip: entries at/above ub prove the window exhausted
        beyond = limb_le(ubh, ubl, u32(rk[..., 0]), u32(rk[..., 1]))
        clipped = rvalid & beyond
        rvalid = rvalid & ~beyond
        rtrunc = rtrunc & ~clipped.any(dim=1)
        rc = rvalid.sum(dim=1)
        # append the round's survivors at each lane's fill level
        tgt = acc_n[:, None] + cols
        put = rvalid & (tgt < limit)
        t2 = torch.where(put, tgt, limit)[..., None].expand(-1, -1, 2)
        m = put[..., None]
        acc_k.scatter_(1, t2, torch.where(m, rk, PAD32))
        acc_v.scatter_(1, t2, torch.where(m, rv, 0))
        acc_n = torch.clamp(acc_n + rc, max=limit)
        active = active & rtrunc & (acc_n < limit)
        if advance_kmin:
            # last emitted key + 1 in int64, carried into the high limb
            lo1 = (u32(cursor.klo) + 1) & 0xFFFFFFFF
            hi1 = (u32(cursor.khi) + (lo1 == 0).to(torch.int64)) & 0xFFFFFFFF
            emitted = rc > 0
            rlo = torch.where(emitted, to_i32(lo1), rlo)
            rhi = torch.where(emitted, to_i32(hi1), rhi)
        cur = cursor.leaf
        rounds += 1
    out_keys = acc_k[:, :limit].contiguous()
    out_vals = acc_v[:, :limit].contiguous()
    out_valid = cols < acc_n[:, None]
    truncated = active  # only a bounded max_rounds leaves lanes active
    cursor = make_cursor(khi, klo, out_keys, acc_n, cur, truncated)
    return out_keys, out_vals, out_valid, truncated, cursor, rounds


def hard_cap_rounds(tree: DeviceTree, max_leaves: int) -> int:
    """Chain-length ceiling on continuation rounds (each active lane
    advances >= ``max_leaves`` leaves per round)."""
    return tree.leaf_next.shape[0] // max(max_leaves, 1) + 2


def range_batch_loop(
    tree: DeviceTree,
    ib: InsertBuffers,
    start_leaf,
    khi,
    klo,
    ub_hi,
    ub_lo,
    *,
    limit: int,
    max_leaves: int = 4,
    max_rounds: int = 0,
):
    """Multi-round RANGE: :func:`range_batch_from` rounds driven by
    :func:`continuation_loop` (see there for the outputs)."""

    def round_fn(start, h, l):
        return range_batch_from(tree, ib, start, h, l, limit=limit, max_leaves=max_leaves)

    return continuation_loop(
        round_fn,
        start_leaf,
        khi,
        klo,
        ub_hi,
        ub_lo,
        limit=limit,
        max_rounds=max_rounds,
        hard_cap=hard_cap_rounds(tree, max_leaves),
    )


# ---------------------------------------------------------------------------
# point-in-time reads (as_of=epoch): serve a frozen snapshot through the
# CURRENT tree.  The store builds a host-side resolve table for epoch E
# (res_table[l] walks the leaf version chain back while the version was born
# after E); here each visited leaf's content is read through its resolved
# ancestor, whose rows epoch retention keeps intact.  Insert buffers are
# skipped: a version epoch is a stitched state (snapshot_epoch flushes).
# ---------------------------------------------------------------------------


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` under the reference's gather rule: a negative id is
    raised by ``len(table)`` once, then every id is clamped to
    ``[0, len(table) - 1]`` (torch indexing would raise on the CPU and is
    undefined on CUDA)."""
    n = table.shape[0]
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    return table[torch.clamp(i, 0, n - 1)]


def get_batch_versioned(tree: DeviceTree, res_table, khi, klo, *, depth: int, eps_inner: int, eps_leaf: int):
    """GET against the epoch pinned by ``res_table``: the live descent, the
    leaf resolved to its epoch-E version, then that leaf's HBM row.  Returns
    (vhi, vlo, found); not-found rows carry leaf residue, as in the
    reference."""
    leaf = take(res_table, traverse(tree, khi, klo, depth=depth, eps_inner=eps_inner))
    _, found, vhi, vlo = leaf_search(tree, leaf, khi, klo, eps_leaf)
    return vhi, vlo, found


def range_batch_from_versioned(tree: DeviceTree, res_table, start_leaf, khi, klo, *, limit: int, max_leaves: int = 4):
    """One bounded versioned walk: follow the CURRENT ``leaf_next`` chain but
    gather each visited leaf's content from its resolved ancestor.  Overlaps
    between ancestors are removed by the key sort and first-occurrence
    dedup; no insert-buffer overlay and no tombstones.  Outputs as
    :func:`range_batch_from`."""
    assert limit >= 1, "limit=0 is guarded by the callers"
    B = khi.shape[0]
    dev = khi.device
    parts = []
    leaf = start_leaf.long()
    alive = start_leaf >= 0
    for _ in range(max_leaves):
        safe = torch.clamp(leaf, min=0)
        r = take(res_table, safe)
        slot = take(tree.leaf_slot, r)
        lk = take(tree.hbm_keys, slot)  # (B,128,2): epoch-E bytes (rows survive)
        lv = take(tree.hbm_vals, slot)
        lvalid = (torch.arange(lk.shape[1], device=dev)[None, :] < take(tree.leaf_count, r)[:, None]) & alive[:, None]
        parts.append((lk, lv, lvalid))
        nxt = take(tree.leaf_next, safe).long()
        alive = alive & (nxt >= 0)
        leaf = nxt

    keys = u32(torch.cat([p[0] for p in parts], dim=1))
    vals = torch.cat([p[1] for p in parts], dim=1)
    valid = torch.cat([p[2] for p in parts], dim=1)
    kh, kl = keys[..., 0], keys[..., 1]
    live = valid & limb_le(u32(khi)[:, None], u32(klo)[:, None], kh, kl)
    kh = torch.where(live, kh, 0xFFFFFFFF)
    kl = torch.where(live, kl, 0xFFFFFFFF)
    # ``jnp.lexsort((kl, kh))``: one stable sort of the key folded into an
    # order-preserving int64
    order = torch.sort((kh - 2**31) * 4294967296 + kl, dim=1, stable=True).indices
    out_keys, out_vals, out_valid, n_found = compact_sorted(
        kh.gather(1, order),
        kl.gather(1, order),
        vals[..., 0].gather(1, order),
        vals[..., 1].gather(1, order),
        live.gather(1, order),
        torch.zeros_like(live),
        limit,
    )
    truncated = alive & (n_found < limit)
    cursor = make_cursor(khi, klo, out_keys, n_found, leaf, truncated)
    return out_keys, out_vals, out_valid, truncated, cursor


def range_batch_loop_versioned(
    tree: DeviceTree,
    res_table,
    start_leaf,
    khi,
    klo,
    ub_hi,
    ub_lo,
    *,
    limit: int,
    max_leaves: int = 4,
    max_rounds: int = 0,
):
    """Multi-round versioned RANGE: :func:`range_batch_from_versioned`
    rounds driven by :func:`continuation_loop` with the k_min advance on."""

    def round_fn(start, h, l):
        return range_batch_from_versioned(tree, res_table, start, h, l, limit=limit, max_leaves=max_leaves)

    return continuation_loop(
        round_fn,
        start_leaf,
        khi,
        klo,
        ub_hi,
        ub_lo,
        limit=limit,
        max_rounds=max_rounds,
        hard_cap=hard_cap_rounds(tree, max_leaves),
        advance_kmin=True,
    )
