"""Host-side patching (Sec 3.2.1 / Figure 6).

A patch consumes one leaf's full insert buffer and produces a stitch batch:

  * UPDATE-only patch  -> in-place value writes on the big-memory pool + a
    buffer clear ("the patcher modifies the values accordingly ... and
    performs no further action").
  * structural patch   -> merge buffer into the leaf contents (newest entry
    wins, tombstones delete), PLA re-segmentation with eps_leaf; a split caps
    new-leaf fill at the *retrain bound* (0.25 x capacity) so future patches
    are absorbed without another split.  Parents are rebuilt bottom-up
    (copy-on-write node granularity — the paper's "the parent must also be
    rebuilt"), recursing toward the root only while splits escalate.  A root
    split adds a level.

The paper's safeguards for racy root stitches (UID probes + queue fences)
map to a structural guarantee here: every plan puts all COPY rows before the
CONNECT pointer swaps, and the store applies them in that order, so a
CONNECT can never reference a row that has not landed.

All ids the patch obsoletes are *returned*, not freed — the store quarantines
them through the epoch manager (Sec 3.2.3).

Interpretation notes (where the paper under-specifies):
  * inner-node splits distribute segments evenly and cap segments/new-node at
    ``round(retrain_bound * 7) = 2`` — the inner-node analogue of sparsely
    populated split leaves;
  * we maintain a ``leaf_next`` chain for range scans (the paper re-descends
    per leaf; we keep re-descent as a fallback and test both give identical
    results).  The extra CONNECT this needs is the predecessor's next-pointer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import pla
from .keys import KEY_MAX
from .stitch import StitchBatch
from .tree import NODE_SEGS, SEG_CAP, TreeImage

OP_PUT = 1
OP_DEL = 2


@dataclass
class PatchResult:
    batch: StitchBatch
    kind: str  # "update" | "structural"
    new_leaves: List[int] = field(default_factory=list)
    depth_changed: bool = False


@dataclass
class BatchPatchResult:
    """One flush cycle's worth of patches merged into a single stitch batch
    (the paper's migrate-in-batches write path).  ``results`` keeps the
    per-leaf classification; every entry aliases the shared ``batch``.
    ``unplanned`` holds (leaf, entries) the planner stopped short of when a
    headroom probe said the pools could not absorb another worst-case patch
    — the store applies this batch, drains, and plans the rest."""

    batch: StitchBatch
    results: List[PatchResult] = field(default_factory=list)
    unplanned: List[Tuple[int, List[Tuple[int, int, int]]]] = field(
        default_factory=list
    )

    @property
    def n_update(self) -> int:
        return sum(1 for r in self.results if r.kind == "update")

    @property
    def n_structural(self) -> int:
        return sum(1 for r in self.results if r.kind == "structural")

    @property
    def new_leaves(self) -> List[int]:
        return [l for r in self.results for l in r.new_leaves]

    @property
    def depth_changed(self) -> bool:
        return any(r.depth_changed for r in self.results)


def _merge(
    img: TreeImage, leaf: int, entries: List[Tuple[int, int, int]]
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Apply buffered ops (in order) to the leaf contents.

    Returns (keys, vals, update_only): update_only is True when every op was
    a PUT to an already-present key (no inserts, no deletes) — the paper's
    cheap path.
    """
    base_keys = img.leaf_keys(leaf)
    base_vals = img.leaf_vals(leaf)
    d = dict(zip(base_keys.tolist(), base_vals.tolist()))
    update_only = True
    for k, v, op in entries:
        k = int(k)
        if op == OP_PUT:
            if k not in d:
                update_only = False
            d[k] = int(v)
        elif op == OP_DEL:
            if k in d:
                del d[k]
            update_only = False
    ks = np.array(sorted(d.keys()), dtype=np.uint64)
    vs = np.array([d[int(k)] for k in ks], dtype=np.uint64)
    return ks, vs, update_only


def _pad_row(values: np.ndarray, fill, width: int = SEG_CAP) -> np.ndarray:
    dtype = values.dtype if values.size else np.uint64
    row = np.full(width, fill, dtype=dtype)
    row[: values.size] = values
    return row


def _emit_leaf(img: TreeImage, batch: StitchBatch, keys, vals, seg: pla.Segment) -> int:
    """COPY a new leaf (+ its data slot) built from one PLA segment."""
    leaf = img.alloc("leaves")
    slot = img.alloc("slots")
    ks = keys[seg.start : seg.start + seg.count]
    vs = vals[seg.start : seg.start + seg.count]
    # image mirror
    img.leaf_anchor[leaf] = seg.anchor
    img.leaf_slope[leaf] = seg.slope
    img.leaf_count[leaf] = seg.count
    img.leaf_slot[leaf] = slot
    img.hbm_keys[slot] = _pad_row(ks, KEY_MAX)
    img.hbm_vals[slot] = _pad_row(vs, 0)
    # device copies
    batch.add_copy("leaf_anchor", leaf, np.uint64(seg.anchor))
    batch.add_copy("leaf_slope", leaf, np.float64(seg.slope))
    batch.add_copy("leaf_count", leaf, np.int32(seg.count))
    batch.add_copy("leaf_slot", leaf, np.int32(slot))
    batch.add_copy("hbm_keys", slot, img.hbm_keys[slot])
    batch.add_copy("hbm_vals", slot, img.hbm_vals[slot])
    return leaf


def _emit_node(
    img: TreeImage,
    batch: StitchBatch,
    segs: List[pla.Segment],
    firsts: np.ndarray,
    children: np.ndarray,
) -> int:
    """COPY a new inner node holding the given segments."""
    node = img.alloc("nodes")
    img.node_nseg[node] = len(segs)
    img.node_seg_first[node] = np.full(NODE_SEGS, KEY_MAX, dtype=np.uint64)
    img.node_seg_slope[node] = 0.0
    img.node_seg_count[node] = 0
    img.node_seg_slot[node] = -1
    for j, seg in enumerate(segs):
        slot = img.alloc("pivots")
        img.node_seg_first[node, j] = seg.anchor
        img.node_seg_slope[node, j] = seg.slope
        img.node_seg_count[node, j] = seg.count
        img.node_seg_slot[node, j] = slot
        sl = slice(seg.start, seg.start + seg.count)
        img.pivot_keys[slot] = _pad_row(firsts[sl], KEY_MAX)
        img.pivot_child[slot] = _pad_row(
            children[sl].astype(np.int32), np.int32(-1)
        ).astype(np.int32)
        batch.add_copy("pivot_keys", slot, img.pivot_keys[slot])
        batch.add_copy("pivot_child", slot, img.pivot_child[slot])
    batch.add_copy("node_seg_first", node, img.node_seg_first[node])
    batch.add_copy("node_seg_slope", node, img.node_seg_slope[node])
    batch.add_copy("node_seg_count", node, img.node_seg_count[node])
    batch.add_copy("node_seg_slot", node, img.node_seg_slot[node])
    return node


def _free_node(img: TreeImage, batch: StitchBatch, node: int) -> None:
    batch.frees.append(("nodes", node))
    for j in range(int(img.node_nseg[node])):
        batch.frees.append(("pivots", int(img.node_seg_slot[node, j])))


def _node_entries(img: TreeImage, node: int) -> Tuple[np.ndarray, np.ndarray]:
    """Flattened (firsts, children) across all live segments of a node."""
    firsts, children = [], []
    for j in range(int(img.node_nseg[node])):
        slot = int(img.node_seg_slot[node, j])
        cnt = int(img.node_seg_count[node, j])
        firsts.append(img.pivot_keys[slot, :cnt])
        children.append(img.pivot_child[slot, :cnt])
    return np.concatenate(firsts), np.concatenate(children)


def _inner_split_caps(img: TreeImage) -> Tuple[int, int]:
    segs_per_node = max(1, int(round(img.cfg.retrain_bound * NODE_SEGS)))
    return segs_per_node, SEG_CAP


def _plan_leaf_replacement(
    img: TreeImage,
    batch: StitchBatch,
    leaf: int,
    merged_keys: np.ndarray,
    merged_vals: np.ndarray,
) -> Tuple[List[int], List[Tuple[int, int, int]], np.ndarray]:
    """Leaf-local half of a structural patch: emit replacement leaves, splice
    the leaf_next chain, free the old leaf.  Parent maintenance is left to
    the caller.  Returns (new leaf ids, the root->leaf path taken, and the
    *routing firsts* the parent must use for the replacements).

    Routing firsts vs leaf anchors: the first replacement inherits the OLD
    leaf's routed lower bound (its parent pivot key), not its own PLA anchor.
    When the old window's lowest keys were deleted, the new anchor is higher
    — re-keying the parent pivot to it would silently hand the gap
    ``[old bound, new anchor)`` to the *predecessor* leaf.  Live reads can't
    tell (the gap is empty), but a versioned read can: epoch-E keys in the
    gap live in THIS leaf's version chain, so the gap must keep routing
    here.  (The single-swap fast path already preserves the pivot key; this
    makes the rebuild path consistent with it.)"""
    old_anchor = np.uint64(img.leaf_anchor[leaf])
    old_next = int(img.leaf_next[leaf])
    old_prev = int(img.leaf_prev[leaf])
    _, path = img.find_leaf(old_anchor)
    route_lb = old_anchor
    if path:
        node, seg, pos = path[-1]
        route_lb = np.uint64(
            img.pivot_keys[int(img.node_seg_slot[node, seg]), pos]
        )

    # ---- build replacement leaves ----------------------------------------
    if merged_keys.size == 0:
        # all deleted: keep a single empty leaf so routing stays total
        segs = [pla.Segment(0, 0, old_anchor, 0.0)]
    else:
        segs = pla.fit(merged_keys, img.cfg.eps_leaf, SEG_CAP)
        if len(segs) > 1:  # splitting -> retrain bound (sparse leaves)
            segs = pla.fit(merged_keys, img.cfg.eps_leaf, img.cfg.split_cap)
    new_leaves = [
        _emit_leaf(img, batch, merged_keys, merged_vals, s) for s in segs
    ]
    # version-chain stamp (point-in-time reads): each replacement leaf is
    # born at the cycle this transaction completes as and supersedes ``leaf``
    for nl in new_leaves:
        img.ver_birth[nl] = img.version_cycle
        img.ver_prev[nl] = leaf

    # chain: prev -> new[0] -> ... -> new[-1] -> old_next
    for a, b in zip(new_leaves, new_leaves[1:]):
        img.leaf_next[a] = b
        img.leaf_prev[b] = a
        batch.add_copy("leaf_next", a, np.int32(b))
    img.leaf_next[new_leaves[-1]] = old_next
    batch.add_copy("leaf_next", new_leaves[-1], np.int32(old_next))
    img.leaf_prev[new_leaves[0]] = old_prev
    if old_next != -1:
        img.leaf_prev[old_next] = new_leaves[-1]
    if old_prev != -1:
        img.leaf_next[old_prev] = new_leaves[0]
        batch.connects.append(("leaf_next", old_prev, new_leaves[0]))
    batch.frees.append(("leaves", leaf))
    batch.frees.append(("slots", int(img.leaf_slot[leaf])))
    route_firsts = np.array(
        [img.leaf_anchor[l] for l in new_leaves], dtype=np.uint64
    )
    route_firsts[0] = min(np.uint64(route_lb), route_firsts[0])
    return new_leaves, path, route_firsts


def plan_patch(
    img: TreeImage,
    leaf: int,
    entries: List[Tuple[int, int, int]],
    batch: Optional[StitchBatch] = None,
    force_structural: bool = False,
) -> PatchResult:
    """Plan the patch for one full insert buffer. Mutates the host image
    (allocations + mirror rows + pointer mirrors) and returns the stitch
    batch the device needs to catch up.

    When ``batch`` is given, commands append to it instead of a fresh batch.
    This is the per-leaf stream (one parent rebuild per patched leaf) — the
    semantic oracle; the batched pipeline is ``plan_patch_batch``.

    ``force_structural`` disables the update-only fast path: it overwrites
    ``hbm_vals`` in place, which destroys the superseded value version —
    stores keeping a point-in-time window (``retain_epochs > 0``) need every
    patch to go copy-on-write through a leaf replacement.
    """
    merged_keys, merged_vals, update_only = _merge(img, leaf, entries)
    if force_structural:
        update_only = False
    if batch is None:
        batch = StitchBatch()
    batch.clear_ib.append(leaf)

    if update_only:
        slot = int(img.leaf_slot[leaf])
        img.hbm_vals[slot] = _pad_row(merged_vals, 0)
        batch.value_updates.append((slot, img.hbm_vals[slot].copy()))
        return PatchResult(batch=batch, kind="update")

    new_leaves, path, child_firsts = _plan_leaf_replacement(
        img, batch, leaf, merged_keys, merged_vals
    )

    # ---- splice into the parent chain ------------------------------------
    child_ids = np.array(new_leaves, dtype=np.int32)
    depth_changed = _splice_up(
        img, batch, path, child_ids, child_firsts, single_swap_ok=len(new_leaves) == 1
    )
    return PatchResult(
        batch=batch,
        kind="structural",
        new_leaves=new_leaves,
        depth_changed=depth_changed,
    )


def _emit_node_group(
    img: TreeImage,
    batch: StitchBatch,
    segs: List[pla.Segment],
    firsts: np.ndarray,
    children: np.ndarray,
    per_node: int,
) -> List[int]:
    """Emit new nodes holding ``segs`` grouped ``per_node`` segments each
    (re-anchored to zero-based starts per node)."""
    nodes = []
    for i in range(0, len(segs), per_node):
        group = segs[i : i + per_node]
        base = group[0].start
        shifted = [
            pla.Segment(s.start - base, s.count, s.anchor, s.slope)
            for s in group
        ]
        lo = base
        hi = group[-1].start + group[-1].count
        nodes.append(
            _emit_node(img, batch, shifted, firsts[lo:hi], children[lo:hi])
        )
    return nodes


def _rebuild_node(
    img: TreeImage,
    batch: StitchBatch,
    firsts: np.ndarray,
    children: np.ndarray,
) -> List[int]:
    """Re-fit one node's flattened entries into new node(s): a single node
    when the segments still fit, else retrain-bound-sparse split nodes.
    Zero entries (every child removed by a chain compaction) yield zero
    nodes — the caller drops the node from ITS parent in turn."""
    if firsts.size == 0:
        return []
    segs = pla.fit(firsts, img.cfg.eps_inner, SEG_CAP)
    max_segs, _ = _inner_split_caps(img)
    per = len(segs) if len(segs) <= NODE_SEGS else max_segs
    return _emit_node_group(img, batch, segs, firsts, children, per)


def _grow_root(
    img: TreeImage,
    batch: StitchBatch,
    child_ids: np.ndarray,
    child_firsts: np.ndarray,
) -> bool:
    """Make ``child_ids`` the new top of the tree: build levels until a
    single node remains (root split adds levels), then CONNECT the root."""
    assert len(child_ids) >= 1, "the tree cannot become empty"
    depth_changed = False
    while len(child_ids) > 1:
        segs = pla.fit(child_firsts, img.cfg.eps_inner, SEG_CAP)
        nodes = _emit_node_group(
            img, batch, segs, child_firsts, child_ids, NODE_SEGS
        )
        child_ids = np.array(nodes, dtype=np.int32)
        child_firsts = np.array(
            [img.node_seg_first[n, 0] for n in nodes], dtype=np.uint64
        )
        img.depth += 1
        depth_changed = True
    img.root = int(child_ids[0])
    batch.connects.append(("root", img.root, img.depth))
    return depth_changed


def _splice_up(
    img: TreeImage,
    batch: StitchBatch,
    path: List[Tuple[int, int, int]],
    child_ids: np.ndarray,
    child_firsts: np.ndarray,
    single_swap_ok: bool,
) -> bool:
    """Replace one child entry with ``child_ids`` bottom-up along ``path``.

    Returns True if the tree depth changed (root split).
    """
    level = len(path) - 1
    while True:
        if level < 0:
            # we replaced the root itself
            return _grow_root(img, batch, child_ids, child_firsts)

        node, seg, pos = path[level]
        if single_swap_ok and len(child_ids) == 1:
            # Figure 6 fast path: one pointer swap in the (unchanged) parent
            slot = int(img.node_seg_slot[node, seg])
            img.pivot_child[slot, pos] = int(child_ids[0])
            batch.connects.append(
                ("pivot_child", slot, pos, int(child_ids[0]))
            )
            return False

        # rebuild this node with the entry at (seg, pos) replaced
        firsts, children = _node_entries(img, node)
        flat_pos = (
            sum(int(img.node_seg_count[node, j]) for j in range(seg)) + pos
        )
        firsts = np.concatenate(
            [firsts[:flat_pos], child_firsts, firsts[flat_pos + 1 :]]
        )
        children = np.concatenate(
            [children[:flat_pos], child_ids, children[flat_pos + 1 :]]
        ).astype(np.int32)
        nodes = _rebuild_node(img, batch, firsts, children)
        _free_node(img, batch, node)
        child_ids = np.array(nodes, dtype=np.int32)
        child_firsts = np.array(
            [img.node_seg_first[n, 0] for n in nodes], dtype=np.uint64
        )
        single_swap_ok = len(nodes) == 1
        level -= 1


def plan_patch_batch(
    img: TreeImage,
    leaves: List[int],
    entries_per_leaf: List[List[Tuple[int, int, int]]],
    headroom_ok=None,
    force_structural: bool = False,
) -> BatchPatchResult:
    """Plan every full leaf of a flush cycle into ONE merged stitch batch
    (Sec 3.2: staged writes migrate to the host in batches and stitch back
    as a single transaction).

    Two phases, which is where the batching wins over the per-leaf stream:

      1. *Leaf phase* (ascending anchor order): merge each buffer, emit
         replacement leaves + chain splices.  Parents are untouched, so
         every root->leaf path is computed against one consistent tree.
      2. *Tree phase*: group all child replacements by parent and rebuild
         each affected node ONCE, bottom-up level by level — the per-leaf
         stream rebuilds a shared parent once per child patched under it,
         which is exactly the redundant host->device traffic (and node-pool
         churn) the paper's batching amortizes.  Nodes where every
         replacement is 1-for-1 take the Figure-6 fast path: pointer-swap
         CONNECTs only, no rebuild.

    The merged batch stays applicable as all-COPYs-then-all-CONNECTs
    because ids freed by the plan are only *recorded* in ``batch.frees`` —
    the store quarantines them after the cycle's connect, so no in-cycle
    allocation can land on a row the old tree still reaches.

    ``headroom_ok()`` (optional) is probed before each leaf plan after the
    first: when the pools cannot absorb another worst-case patch the planner
    stops and returns the rest via ``unplanned`` — the caller applies,
    drains, and replans.  The first leaf always plans (if the pools truly
    cannot take one patch, the allocator raises exactly as the per-leaf
    stream would).
    """
    batch = StitchBatch()
    order = sorted(
        range(len(leaves)), key=lambda i: int(img.leaf_anchor[leaves[i]])
    )
    results: List[PatchResult] = []
    unplanned: List[Tuple[int, List[Tuple[int, int, int]]]] = []
    # (path, new_leaf_ids, routing firsts) per structural patch, anchor order
    repl: List[Tuple[List[Tuple[int, int, int]], List[int], np.ndarray]] = []
    parents_touched = set()  # distinct parents with structural work queued

    # ---- phase 1: leaf-local patches -------------------------------------
    for k, i in enumerate(order):
        if (
            k > 0
            and headroom_ok is not None
            and not headroom_ok(len(parents_touched))
        ):
            unplanned = [(leaves[j], entries_per_leaf[j]) for j in order[k:]]
            break
        leaf = leaves[i]
        entries = entries_per_leaf[i]
        merged_keys, merged_vals, update_only = _merge(img, leaf, entries)
        if force_structural:  # copy-on-write for point-in-time retention
            update_only = False
        batch.clear_ib.append(leaf)
        if update_only:
            slot = int(img.leaf_slot[leaf])
            img.hbm_vals[slot] = _pad_row(merged_vals, 0)
            batch.value_updates.append((slot, img.hbm_vals[slot].copy()))
            results.append(PatchResult(batch=batch, kind="update"))
            continue
        new_leaves, path, route_firsts = _plan_leaf_replacement(
            img, batch, leaf, merged_keys, merged_vals
        )
        repl.append((path, new_leaves, route_firsts))
        if path:
            parents_touched.add(path[-1][0])
        results.append(
            PatchResult(batch=batch, kind="structural", new_leaves=new_leaves)
        )

    # ---- phase 2: bottom-up tree maintenance, one rebuild per node -------
    depth_changed = _maintain_tree(img, batch, repl)
    for r in results:
        if r.kind == "structural":
            r.depth_changed = depth_changed
    return BatchPatchResult(batch=batch, results=results, unplanned=unplanned)


def plan_chain_compaction(
    img: TreeImage, stubs: List[int]
) -> Tuple[StitchBatch, int]:
    """Plan the removal of empty routing-stub leaves as ONE stitch batch.

    ``extract_slice`` (and an all-deleting patch) keeps a fully-emptied
    leaf in the chain as an empty stub so routing stays total; over many
    rebalance cycles those stubs accumulate.  Removal is the
    zero-replacement case of a structural patch: splice the predecessor's
    ``leaf_next`` past the stub (a CONNECT), free the stub's leaf + slot
    rows (quarantined by the caller's epoch bookkeeping, which also drops
    any scan anchors on them), and drop the stub's entry from its parent —
    ``_maintain_tree`` with an empty replacement list, which rebuilds each
    affected node once and cascades the drop upward when a node empties
    out.  Keys that routed to a removed stub route to its predecessor
    afterwards (the floor search lands one entry earlier), whose chain walk
    covers the merged window — routing stays total, scans stay exact.

    Callers must pass stubs that are live-empty (``leaf_count == 0``), have
    an empty insert buffer, and a predecessor in the chain (the head stub
    is kept so at least one leaf always survives).  Returns (batch,
    n_removed); stubs whose anchor no longer routes to them are skipped
    defensively.
    """
    batch = StitchBatch()
    repl: List[Tuple[List[Tuple[int, int, int]], List[int], np.ndarray]] = []
    for leaf in stubs:
        leaf = int(leaf)
        assert int(img.leaf_count[leaf]) == 0, "only empty stubs are removable"
        found, path = img.find_leaf(np.uint64(img.leaf_anchor[leaf]))
        if found != leaf or not path:  # unroutable, or the depth-1 root leaf
            continue
        prev = int(img.leaf_prev[leaf])
        nxt = int(img.leaf_next[leaf])
        assert prev != -1, "keep the chain head; remove only interior stubs"
        img.leaf_next[prev] = nxt
        batch.connects.append(("leaf_next", prev, nxt))
        if nxt != -1:
            img.leaf_prev[nxt] = prev
        img.leaf_prev[leaf] = -1
        img.leaf_next[leaf] = -1
        batch.frees.append(("leaves", leaf))
        batch.frees.append(("slots", int(img.leaf_slot[leaf])))
        repl.append(
            # zero replacements: drop the entry from the parent
            (path, [], np.array([], dtype=np.uint64))
        )
    _maintain_tree(img, batch, repl)
    return batch, len(repl)


def _maintain_tree(
    img: TreeImage,
    batch: StitchBatch,
    repl: List[Tuple[List[Tuple[int, int, int]], List[int], np.ndarray]],
) -> bool:
    """Phase 2 of the batched planner: propagate child replacements upward,
    rebuilding every affected inner node at most once per cycle.

    ``repl`` holds (root->leaf path, replacement ids, routing firsts) per
    structural patch, in ascending anchor order.  Returns True if the tree
    depth changed.
    """
    if not repl:
        return False

    if img.depth == 1:
        # the root IS the (single) leaf: re-anchor the top of the tree
        assert len(repl) == 1, "depth-1 tree has exactly one leaf"
        _, new_leaves, firsts = repl[0]
        ids = np.array(new_leaves, dtype=np.int32)
        return _grow_root(img, batch, ids, firsts)

    # per level (bottom inner level first): node -> list of replacement
    # points (flat position computed lazily, seg/pos from the original node)
    level = img.depth - 2  # index into each path; paths all have this length
    # pending[node] = list of (seg, pos, child_ids, child_firsts)
    pending: Dict[int, List[Tuple[int, int, np.ndarray, np.ndarray]]] = {}
    # where each affected node sits in ITS parent: node -> (seg, pos) + the
    # parent path prefix (identical for all children of that node)
    parent_entry: Dict[int, Tuple[List[Tuple[int, int, int]], int, int]] = {}

    for path, new_leaves, firsts in repl:
        node, seg, pos = path[level]
        ids = np.array(new_leaves, dtype=np.int32)
        pending.setdefault(node, []).append((seg, pos, ids, firsts))
        parent_entry[node] = (path, None, None)  # path prefix carrier

    depth_changed = False
    while level >= 0:
        next_pending: Dict[int, List[Tuple[int, int, np.ndarray, np.ndarray]]] = {}
        next_parent: Dict[int, Tuple[List[Tuple[int, int, int]], int, int]] = {}
        for node, points in pending.items():
            path = parent_entry[node][0]
            if all(len(p[2]) == 1 for p in points):
                # Figure 6 fast path: nothing but 1-for-1 pointer swaps
                for seg, pos, ids, _ in points:
                    slot = int(img.node_seg_slot[node, seg])
                    img.pivot_child[slot, pos] = int(ids[0])
                    batch.connects.append(
                        ("pivot_child", slot, pos, int(ids[0]))
                    )
                continue
            # rebuild this node once with every replacement point substituted
            flat_firsts, flat_children = _node_entries(img, node)
            seg_starts = np.cumsum(
                [0]
                + [
                    int(img.node_seg_count[node, j])
                    for j in range(int(img.node_nseg[node]) - 1)
                ]
            )
            subs = sorted(
                (
                    (int(seg_starts[seg]) + pos, ids, firsts)
                    for seg, pos, ids, firsts in points
                ),
                key=lambda t: t[0],
            )
            pieces_f, pieces_c = [], []
            cur = 0
            for fp, ids, firsts in subs:
                pieces_f.append(flat_firsts[cur:fp])
                pieces_c.append(flat_children[cur:fp])
                pieces_f.append(firsts)
                pieces_c.append(ids)
                cur = fp + 1
            pieces_f.append(flat_firsts[cur:])
            pieces_c.append(flat_children[cur:])
            firsts = np.concatenate(pieces_f)
            children = np.concatenate(pieces_c).astype(np.int32)
            nodes = _rebuild_node(img, batch, firsts, children)
            _free_node(img, batch, node)
            new_ids = np.array(nodes, dtype=np.int32)
            new_firsts = np.array(
                [img.node_seg_first[n, 0] for n in nodes], dtype=np.uint64
            )
            if level == 0:
                # we rebuilt the root: cap the tree (may add levels)
                depth_changed |= _grow_root(img, batch, new_ids, new_firsts)
            else:
                pnode, pseg, ppos = path[level - 1]
                next_pending.setdefault(pnode, []).append(
                    (pseg, ppos, new_ids, new_firsts)
                )
                next_parent[pnode] = (path, None, None)
        pending = next_pending
        parent_entry = next_parent
        level -= 1
    return depth_changed
