"""Range-partitioned distributed tier: boundary routing + scatter-gather
RANGE — the PyTorch port of the JAX package's ``distributed/rangeshard.py``.

Why a second partition.  The paper's headline RANGE result relies on leaves
being chained in key order; the hash tier (``kvshard``) destroys that order
across shards, so a scan there must broadcast to every shard.  This module
keeps the *global* order: the u64 key space is cut at quantile boundaries
fitted over the loaded keys (``core.pla.fit_boundaries``), each shard
bulk-loads its contiguous slice into its own ``DPAStore``, and every
request is routed by a boundary search that is bit-identical between the
numpy client (``np.searchsorted(b, k, 'right')``) and the device wave
(count of boundaries <= key, an unsigned compare of the u32 limbs).

Scatter-gather RANGE.  A RANGE(k_min, limit) may spill past its owner
shard's slice, so the wave fans each request out to the owner and its
``fanout - 1`` successors (successors scan from their slice start).  Shard
slices are disjoint and ascending, so the gather epilogue concatenates each
request's per-shard results in shard order — already globally sorted — and
compacts the first ``limit`` live entries.  Fan-out replicas past the last
shard are dropped at bucketize time and count as complete empties.

RETRY semantics.  The exchange uses the same fixed per-shard-pair capacity
as the GET wave (``kvshard._bucketize``): a replica that overflows its
(src, dst) bucket comes back with the request's ``ok`` flag False and the
client re-sends.  A request is ``ok`` only if every in-range replica of its
fan-out landed.

In-mesh continuation.  Each shard serves its sub-queries in one call: the
descent (``lookup.traverse``), then the multi-round walk of
``kernels.ops.range_scan_loop`` (kernel B3 plus the insert-buffer merge),
which re-walks only truncated lanes from their cursor and clips every round
to the sub-query's owned window.  The reference runs that loop as one
``lax.while_loop`` under ``vmap``; here it is a loop over shards, each with
its own round count, equal to the reference's per-shard ``rounds``.  The
gather epilogue drops contributions past the first truncated replica (the
output is always an exact ascending prefix of the oracle answer) and
surfaces a per-request ``truncated`` flag, which fires only for a bounded
``max_rounds``.

Ownership windows + epoch tags (rebalance safety).  Requests carry an
``epoch_tag`` (0 = previous boundary vector, 1 = current) through the
exchange; owner search, successor lower bounds and the per-round upper clip
all follow the admitted epoch, so mid-rebalance a donor's stale copy stays
visible to old-epoch requests and invisible to new-epoch ones.

JAX drops out-of-range scatter writes; here every such scatter writes into
one scratch row or column that is sliced away.  The multi-device exchange
(``range_wave_sharded``) is not part of this module yet.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import lookup
from ..core.keys import limb_le, limbs_to_tensor, split_u64, u32
from ..kernels import ops
from .kvshard import _bucketize, _drop_scatter, shard_state


def boundary_limbs(boundaries: np.ndarray, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_shards-1,) u64 boundary array -> (hi, lo) int32-held u32 limb
    tensors on ``device``."""
    limbs = limbs_to_tensor(split_u64(np.asarray(boundaries, dtype=np.uint64)).reshape(-1, 2), device)
    return limbs[:, 0].contiguous(), limbs[:, 1].contiguous()


def replica_serving_stores(groups, primary) -> list:
    """The store that serves each shard group under a given primary map
    (``OwnershipTable.primary_for(epoch)``).  A crashed slot falls back to
    the group's first live replica — the pre-failover map legitimately
    points at the replica whose death opened the handoff, and any live
    replica is content-identical (synchronous write fan-out), so the wave
    results are bitwise the same under either live epoch."""
    serving = []
    for g, p in zip(groups, primary):
        st = g[int(p)]
        if st is None:
            st = next((r for r in g if r is not None), None)
        assert st is not None, "shard group has no live replica"
        serving.append(st)
    return serving


def route_range(b_hi, b_lo, khi, klo):
    """Owner shard per request key: count of shard-start boundaries <= key,
    an unsigned compare of the limbs (bit-identical to
    ``np.searchsorted(boundaries, key, side='right')``)."""
    if b_hi.shape[0] == 0:
        return torch.zeros(khi.shape, dtype=torch.int32, device=khi.device)
    bh, bl = u32(b_hi.to(khi.device)), u32(b_lo.to(khi.device))
    le = limb_le(bh[None, :], bl[None, :], u32(khi)[:, None], u32(klo)[:, None])
    return le.sum(dim=1).to(torch.int32)


def route_range_epoch(bp_hi, bp_lo, bc_hi, bc_lo, epoch_tag, khi, klo):
    """Two-phase ownership routing for a mixed in-flight wave: each request
    routes by the boundary vector of the epoch it carries (``epoch_tag``:
    0 = previous vector, 1 = current) — the device analogue of
    ``OwnershipTable.route(keys, epoch=...)``."""
    d_prev = route_range(bp_hi, bp_lo, khi, klo)
    d_cur = route_range(bc_hi, bc_lo, khi, klo)
    return torch.where(epoch_tag > 0, d_cur, d_prev)


def make_route_fn(boundaries: np.ndarray):
    """Device route_fn(khi, klo) for the GET wave paths in ``kvshard`` (the
    boundary limbs follow the keys' device)."""
    b_hi, b_lo = boundary_limbs(boundaries)
    return partial(route_range, b_hi, b_lo)


def _lower_bounds(b_hi, b_lo):
    zero = torch.zeros(1, dtype=torch.int32, device=b_hi.device)
    return torch.cat([zero, b_hi]), torch.cat([zero, b_lo])


def _replicate(bp_hi, bp_lo, bc_hi, bc_lo, tag, khi, klo, n_shards: int, fanout: int):
    """Fan each request out to its owner shard and ``fanout - 1`` successors,
    routing each request under the boundary vector of the epoch it carries
    (``tag``: 0 = previous, 1 = current; the same vector twice for a
    single-epoch wave).

    Returns (rep_hi, rep_lo, rep_tag, dest, oob) with the replica dim
    innermost: replica ``j*fanout + f`` of request ``j`` targets
    ``owner_j + f``.  Replicas past the last shard get the ``n_shards``
    drop sentinel and are flagged ``oob`` (complete empties, not RETRYs).
    A successor replica's scan starts at its destination's slice start under
    its own epoch (the ownership-window lower bound that keeps a donor's
    migrated-away slice out of the gather mid-handoff)."""
    W = khi.shape[0]
    dev = khi.device
    owner = route_range_epoch(bp_hi, bp_lo, bc_hi, bc_lo, tag, khi, klo)
    rep_hi = khi.repeat_interleave(fanout)
    rep_lo = klo.repeat_interleave(fanout)
    rep_tag = tag.repeat_interleave(fanout)
    off = torch.arange(fanout, dtype=torch.int32, device=dev).repeat(W)
    dest = owner.repeat_interleave(fanout) + off
    oob = dest >= n_shards
    lbp_hi, lbp_lo = _lower_bounds(bp_hi.to(dev), bp_lo.to(dev))
    lbc_hi, lbc_lo = _lower_bounds(bc_hi.to(dev), bc_lo.to(dev))
    safe_dest = torch.clamp(dest, 0, n_shards - 1).long()
    d_hi = torch.where(rep_tag > 0, lbc_hi[safe_dest], lbp_hi[safe_dest])
    d_lo = torch.where(rep_tag > 0, lbc_lo[safe_dest], lbp_lo[safe_dest])
    use_lb = ~limb_le(u32(d_hi), u32(d_lo), u32(rep_hi), u32(rep_lo))  # slice start > k_min
    rep_hi = torch.where(use_lb, d_hi, rep_hi)
    rep_lo = torch.where(use_lb, d_lo, rep_lo)
    return rep_hi, rep_lo, rep_tag, torch.where(oob, n_shards, dest).to(torch.int32), oob


def _upper_bound_limbs(b_hi, b_lo):
    """(n_shards,) per-shard owned-window upper bounds: the successor's
    start boundary, KEY_MAX limbs for the last shard."""
    pad = torch.full((1,), -1, dtype=torch.int32, device=b_hi.device)  # 0xFFFFFFFF
    return torch.cat([b_hi, pad]), torch.cat([b_lo, pad])


def _gather_epilogue(
    origin, valid, oob, rs_kh, rs_kl, rs_vh, rs_vl, rs_valid, rs_trunc,
    *, W: int, fanout: int, limit: int,
):
    """Stitch one source shard's fan-out responses into per-request outputs.

    ``origin``/``valid`` are this shard's bucketize maps ((n_dest, cap),
    origin indexing the W*fanout replica stream); ``rs_*`` are the routed-
    back responses ((n_dest, cap, limit)).  Per-shard results are disjoint
    ascending slices, so a request's replicas concatenated in fan-out order
    are already sorted — compact the first ``limit`` live entries.  Every
    contribution past the first truncated replica is dropped (it would leave
    a gap), and the flag folds into the per-request ``truncated`` output."""
    WF = W * fanout
    flat = origin.reshape(-1)
    idx = torch.where(flat >= 0, flat.to(torch.int64), WF)
    r_kh = _drop_scatter(WF, 0, torch.int32, idx, rs_kh.reshape(-1, limit), (limit,))
    r_kl = _drop_scatter(WF, 0, torch.int32, idx, rs_kl.reshape(-1, limit), (limit,))
    r_vh = _drop_scatter(WF, 0, torch.int32, idx, rs_vh.reshape(-1, limit), (limit,))
    r_vl = _drop_scatter(WF, 0, torch.int32, idx, rs_vl.reshape(-1, limit), (limit,))
    r_valid = _drop_scatter(WF, False, torch.bool, idx, rs_valid.reshape(-1, limit), (limit,))
    r_trunc = _drop_scatter(WF, False, torch.bool, idx, rs_trunc.reshape(-1))
    r_ok = _drop_scatter(WF, False, torch.bool, idx, valid.reshape(-1))
    r_ok = r_ok | oob  # past-the-end replicas are complete empties

    cat = [r.reshape(W, fanout * limit) for r in (r_kh, r_kl, r_vh, r_vl)]
    # a truncated replica breaks contiguity: keep only replicas strictly
    # before the first truncated one (plus its own valid prefix)
    tr = r_trunc.reshape(W, fanout).to(torch.int32)
    prefix_ok = torch.cumsum(tr, dim=1) == tr  # True through the first truncated replica
    cat_valid = (r_valid.reshape(W, fanout, limit) & prefix_ok[:, :, None]).reshape(W, fanout * limit)

    target = torch.cumsum(cat_valid.to(torch.int64), dim=1) - 1
    in_out = cat_valid & (target < limit)
    tgt = torch.where(in_out, target, limit)  # overflow -> scratch column
    outs = []
    for c in cat:
        o = torch.zeros((W, limit + 1), dtype=torch.int32, device=c.device)
        o.scatter_(1, tgt, torch.where(in_out, c, 0))
        outs.append(o[:, :limit])
    n_found = torch.clamp(cat_valid.sum(dim=1), max=limit)
    out_valid = torch.arange(limit, device=n_found.device)[None, :] < n_found[:, None]
    ok = r_ok.reshape(W, fanout).all(dim=1)
    truncated = (n_found < limit) & r_trunc.reshape(W, fanout).any(dim=1)
    return (*outs, out_valid, ok, truncated)


def _serve_subqueries(
    tree, ib, rq_hi, rq_lo, rq_tag, rq_live, ub_prev, ub_cur,
    *, depth: int, eps_inner: int, limit: int, max_leaves: int, max_rounds: int,
):
    """One shard's half of the wave: descend to each landed sub-query's
    floor leaf, then run the whole multi-round continuation in one call of
    ``kernels.ops.range_scan_loop`` (kernel B3 a round), clipping every
    round to the sub-query's owned window under the epoch it carries
    (``rq_tag``).  Slots where no request landed (``rq_live`` 0) ride along
    as dead lanes (start leaf -1).  Returns (keys, vals, valid, truncated,
    rounds)."""
    hf = rq_hi.reshape(-1).contiguous()
    lf = rq_lo.reshape(-1).contiguous()
    tf = rq_tag.reshape(-1)
    ub_hi = torch.where(tf > 0, ub_cur[0], ub_prev[0]).contiguous()
    ub_lo = torch.where(tf > 0, ub_cur[1], ub_prev[1]).contiguous()
    start = lookup.traverse(tree, hf, lf, depth=depth, eps_inner=eps_inner)
    start = torch.where(rq_live.reshape(-1) > 0, start, -1)
    rk, rv, rvalid, rtrunc, _, rounds = ops.range_scan_loop(
        tree, ib, hf, lf,
        depth=depth, eps_inner=eps_inner, limit=limit, max_leaves=max_leaves,
        max_rounds=max_rounds, start_leaf=start, ub_hi=ub_hi, ub_lo=ub_lo,
    )
    return rk, rv, rvalid, rtrunc, rounds


def _epoch_inputs(boundaries, boundaries_prev, device):
    """(prev, cur) boundary limb pairs; a single-epoch wave repeats cur."""
    cur = boundary_limbs(boundaries, device)
    if boundaries_prev is None:
        return cur, cur
    return boundary_limbs(boundaries_prev, device), cur


def range_wave_emulated(
    stacked_tree,
    stacked_ib,
    khi: torch.Tensor,  # (n_shards, W) per-client-shard k_min limbs
    klo: torch.Tensor,
    boundaries: np.ndarray,
    *,
    cap: int,
    depth: int,
    eps_inner: int,
    limit: int,
    max_leaves: int = 4,
    fanout: Optional[int] = None,
    max_rounds: int = 0,
    boundaries_prev: Optional[np.ndarray] = None,
    epoch_tag: Optional[torch.Tensor] = None,
):
    """Single-device emulation of the scatter-gather RANGE wave with the
    in-mesh continuation loop: a loop over shards, the exchange a transpose.

    Returns (out_kh, out_kl, out_vh, out_vl, out_valid, ok, truncated,
    rounds); the first seven carry a leading (n_shards, W) client layout
    (rows are ascending live entries with ``out_valid`` a prefix mask),
    ``rounds`` is the per-serving-shard count of continuation rounds
    ((n_shards,) int32).  ``ok=False`` means a capacity overflow dropped
    part of the fan-out — RETRY, never silent loss.  With the default
    ``max_rounds=0`` the loop runs until every lane hit ``limit``,
    exhausted its chain or ran into its owned window, so ``truncated`` only
    surfaces for a bounded ``max_rounds``.

    ``epoch_tag`` ((n_shards, W) i32; 0 = previous epoch, 1 = current,
    requires ``boundaries_prev``) routes a mixed in-flight wave per
    request."""
    n_shards, W = khi.shape
    dev = khi.device
    fanout = n_shards if fanout is None else fanout
    (bp_hi, bp_lo), (bc_hi, bc_lo) = _epoch_inputs(boundaries, boundaries_prev, dev)
    tag = (
        torch.as_tensor(epoch_tag, dtype=torch.int32, device=dev)
        if epoch_tag is not None
        else torch.ones((n_shards, W), dtype=torch.int32, device=dev)
    )
    src = []
    for s in range(n_shards):
        rep_hi, rep_lo, rep_tag, dest, oob = _replicate(
            bp_hi, bp_lo, bc_hi, bc_lo, tag[s], khi[s], klo[s], n_shards, fanout
        )
        src.append((*_bucketize(dest, rep_hi, rep_lo, n_shards, cap, extra=(rep_tag,)), oob))
    bk_hi, bk_lo, origin, valid, bk_tag, oob = (torch.stack(x) for x in zip(*src))
    rq_hi = bk_hi.transpose(0, 1)  # (dest, src, cap)
    rq_lo = bk_lo.transpose(0, 1)
    rq_tag = bk_tag.transpose(0, 1)
    rq_live = valid.transpose(0, 1).to(torch.int32)
    ubp = _upper_bound_limbs(bp_hi, bp_lo)  # each (n_shards,)
    ubc = _upper_bound_limbs(bc_hi, bc_lo)
    served = []
    for d in range(n_shards):
        tree, ib = shard_state(stacked_tree, stacked_ib, d)
        served.append(
            _serve_subqueries(
                tree, ib, rq_hi[d], rq_lo[d], rq_tag[d], rq_live[d],
                (ubp[0][d], ubp[1][d]), (ubc[0][d], ubc[1][d]),
                depth=depth, eps_inner=eps_inner, limit=limit,
                max_leaves=max_leaves, max_rounds=max_rounds,
            )
        )
    rk, rv, rvalid, rtrunc = (torch.stack([sv[i] for sv in served]) for i in range(4))
    rounds = torch.tensor([sv[4] for sv in served], dtype=torch.int32, device=dev)
    # responses back: (dest, src, cap, limit) -> (src, dest, cap, limit)
    shape = (n_shards, n_shards, cap, limit)
    rs_kh = rk[..., 0].reshape(shape).transpose(0, 1)
    rs_kl = rk[..., 1].reshape(shape).transpose(0, 1)
    rs_vh = rv[..., 0].reshape(shape).transpose(0, 1)
    rs_vl = rv[..., 1].reshape(shape).transpose(0, 1)
    rs_valid = rvalid.reshape(shape).transpose(0, 1)
    rs_trunc = rtrunc.reshape(shape[:3]).transpose(0, 1)
    outs = [
        _gather_epilogue(
            origin[s], valid[s], oob[s], rs_kh[s], rs_kl[s], rs_vh[s], rs_vl[s], rs_valid[s], rs_trunc[s],
            W=W, fanout=fanout, limit=limit,
        )
        for s in range(n_shards)
    ]
    return tuple(torch.stack(x) for x in zip(*outs)) + (rounds,)
