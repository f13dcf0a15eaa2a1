"""Learned index tree — host image (the paper's host-side replica) and device pools.

PyTorch port of the JAX package's ``core/tree.py``: the host image and the
bulk loader are the same numpy code; the device pools are torch tensors,
with every u32 pool held as int32 bit patterns (see ``keys.py``).

Layout follows Sec 3.1 / Figure 4 of the paper:

  * **Inner node** = up to 7 segments.  The segments' first keys plus node
    metadata are the node's *hot* data (paper: one cache line); each segment
    carries a PLA model (slope; the anchor IS the segment's first key, the
    intercept is 0 in local-rank space) and points to a *pivot slot* of up to
    128 pivot keys + child pointers (paper: pivots and children stored
    separately to pack more comparisons per cache line — we keep them as
    separate pools for exactly the same reason: the GET kernel reads the
    pivot window without dragging the children along).
  * **Leaf node** = PLA model + pointer to a *data slot* of up to 128
    key/value pairs living in the big-memory pool ("host memory" in the
    paper, device memory here).
  * **Insert buffers** (one per leaf, NIC-side in the paper) are device
    arrays managed by ``store.py``.

Everything has two representations:

  * :class:`TreeImage` — mutable numpy (u64 keys, f64 slopes).  This is the
    *host tree replica* the paper maintains for patching; all structural
    maintenance happens here, never on device.
  * :class:`DeviceTree` — torch pools (u32 limb keys, f32 slopes)
    built from the image, updated only through stitch command streams
    (``stitch.py``) exactly like the NIC-side tree.

Ids are pool indices; ``-1`` is null.  Key ``2^64-1`` is a reserved padding
sentinel (real keys must be strictly smaller).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import pla
from .keys import KEY_MAX, limbs_to_tensor, split_u64

SEG_CAP = 128  # pivots per segment / keys per leaf (paper: 128)
NODE_SEGS = 7  # segments per inner node (paper: 7)


@dataclass(frozen=True)
class TreeConfig:
    eps_inner: int = 4
    eps_leaf: int = 8
    ib_cap: int = 16  # insert-buffer entries per leaf
    retrain_bound: float = 0.25  # split segments filled to <= bound*SEG_CAP
    growth: float = 4.0  # pool headroom factor over the bulk-loaded size

    @property
    def split_cap(self) -> int:
        return max(1, int(self.retrain_bound * SEG_CAP))


class DeviceTree(NamedTuple):
    """Device pools (see module docstring).  Every key pool holds u32 limbs
    as int32 bit patterns.  The stitch path updates them in place."""

    root: torch.Tensor  # () i32 — inner node id (or leaf id when depth == 1)
    node_seg_first: torch.Tensor  # (Ni, 7, 2) u32-in-i32, padded KEY_MAX
    node_seg_slope: torch.Tensor  # (Ni, 7) f32
    node_seg_count: torch.Tensor  # (Ni, 7) i32
    node_seg_slot: torch.Tensor  # (Ni, 7) i32 -> pivot slot id
    pivot_keys: torch.Tensor  # (Np, 128, 2) u32-in-i32, padded KEY_MAX
    pivot_child: torch.Tensor  # (Np, 128) i32
    leaf_anchor: torch.Tensor  # (Nl, 2) u32-in-i32
    leaf_slope: torch.Tensor  # (Nl,) f32
    leaf_count: torch.Tensor  # (Nl,) i32
    leaf_slot: torch.Tensor  # (Nl,) i32 -> hbm slot id
    leaf_next: torch.Tensor  # (Nl,) i32 — next leaf in key order (-1 = end)
    hbm_keys: torch.Tensor  # (Ns, 128, 2) u32-in-i32, padded KEY_MAX
    hbm_vals: torch.Tensor  # (Ns, 128, 2) u32-in-i32


@dataclass
class TreeImage:
    """Mutable host replica + allocator state."""

    cfg: TreeConfig
    depth: int  # number of levels including the leaf level (>= 1)
    root: int
    node_nseg: np.ndarray  # (Ni,) i32
    node_seg_first: np.ndarray  # (Ni, 7) u64 (padded KEY_MAX)
    node_seg_slope: np.ndarray  # (Ni, 7) f64
    node_seg_count: np.ndarray  # (Ni, 7) i32
    node_seg_slot: np.ndarray  # (Ni, 7) i32
    pivot_keys: np.ndarray  # (Np, 128) u64
    pivot_child: np.ndarray  # (Np, 128) i32
    leaf_anchor: np.ndarray  # (Nl,) u64
    leaf_slope: np.ndarray  # (Nl,) f64
    leaf_count: np.ndarray  # (Nl,) i32
    leaf_slot: np.ndarray  # (Nl,) i32
    leaf_next: np.ndarray  # (Nl,) i32
    leaf_prev: np.ndarray  # (Nl,) i32 — HOST-ONLY (patcher predecessor lookup;
    #   the NIC tree has no prev pointers, matching the paper's no-parent-
    #   pointer rule: bidirectional refs under concurrency are a liability)
    hbm_keys: np.ndarray  # (Ns, 128) u64
    hbm_vals: np.ndarray  # (Ns, 128) u64
    free_nodes: List[int] = field(default_factory=list)
    free_pivots: List[int] = field(default_factory=list)
    free_leaves: List[int] = field(default_factory=list)
    free_slots: List[int] = field(default_factory=list)
    # -- leaf version chain (HOST-ONLY; point-in-time reads) ---------------
    # ver_birth[l] = stitch cycle that emitted leaf l (0 = bulk load);
    # ver_prev[l] = the leaf l replaced (-1 = none).  A versioned read at
    # as_of=E walks ver_prev while ver_birth > E — epoch retention
    # (EpochManager.retain) keeps every reachable ancestor un-recycled.
    ver_birth: Optional[np.ndarray] = None  # (Nl,) i64
    ver_prev: Optional[np.ndarray] = None  # (Nl,) i32
    # the cycle number the in-flight stitch transaction will complete as;
    # store.py refreshes it right before planning each transaction
    version_cycle: int = 0

    def __post_init__(self):
        n = self.leaf_anchor.shape[0]
        if self.ver_birth is None:
            self.ver_birth = np.zeros(n, dtype=np.int64)
        if self.ver_prev is None:
            self.ver_prev = np.full(n, -1, dtype=np.int32)

    # -- allocation -------------------------------------------------------
    def alloc(self, pool: str) -> int:
        free = getattr(self, f"free_{pool}")
        if not free:
            raise MemoryError(
                f"tree pool '{pool}' exhausted — raise TreeConfig.growth"
            )
        return free.pop()

    def release(self, pool: str, idx: int) -> None:
        getattr(self, f"free_{pool}").append(int(idx))

    # -- host-side descent (the paper's patcher re-descends from the root
    #    instead of maintaining parent pointers; Sec 3.2.1) ----------------
    def route(self, node: int, key: np.uint64) -> Tuple[int, int, int]:
        """Within inner ``node``: (segment, position-in-segment, child id)."""
        nseg = int(self.node_nseg[node])
        firsts = self.node_seg_first[node, :nseg]
        seg = int(np.searchsorted(firsts, key, side="right")) - 1
        seg = max(seg, 0)
        slot = int(self.node_seg_slot[node, seg])
        cnt = int(self.node_seg_count[node, seg])
        piv = self.pivot_keys[slot, :cnt]
        pos = int(np.searchsorted(piv, key, side="right")) - 1
        pos = max(pos, 0)
        return seg, pos, int(self.pivot_child[slot, pos])

    def find_leaf(self, key: np.uint64) -> Tuple[int, List[Tuple[int, int, int]]]:
        """Leaf id for ``key`` + the (node, seg, pos) path taken (for patching)."""
        path: List[Tuple[int, int, int]] = []
        if self.depth == 1:
            return self.root, path
        node = self.root
        for _ in range(self.depth - 1):
            seg, pos, child = self.route(node, key)
            path.append((node, seg, pos))
            node = child
        return node, path

    def leaf_keys(self, leaf: int) -> np.ndarray:
        return self.hbm_keys[self.leaf_slot[leaf], : self.leaf_count[leaf]]

    def leaf_vals(self, leaf: int) -> np.ndarray:
        return self.hbm_vals[self.leaf_slot[leaf], : self.leaf_count[leaf]]

    def first_leaf(self) -> int:
        if self.depth == 1:
            return self.root
        node = self.root
        for _ in range(self.depth - 1):
            slot = int(self.node_seg_slot[node, 0])
            node = int(self.pivot_child[slot, 0])
        return node

    def iter_items(self):
        """Ordered (key, value) pairs of the *stitched* tree (no insert buffers)."""
        leaf = self.first_leaf()
        while leaf != -1:
            cnt = int(self.leaf_count[leaf])
            slot = int(self.leaf_slot[leaf])
            for i in range(cnt):
                yield self.hbm_keys[slot, i], self.hbm_vals[slot, i]
            leaf = int(self.leaf_next[leaf])

    # -- device export ----------------------------------------------------
    def to_device(self, device) -> DeviceTree:
        def i32(a):
            # always a copy: on the CPU ``.to`` keeps the memory, and the
            # device pools must not alias the host image the patcher edits
            return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)

        def f32(a):
            return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

        return DeviceTree(
            root=torch.tensor(self.root, dtype=torch.int32, device=device),
            node_seg_first=limbs_to_tensor(split_u64(self.node_seg_first), device),
            node_seg_slope=f32(self.node_seg_slope),
            node_seg_count=i32(self.node_seg_count),
            node_seg_slot=i32(self.node_seg_slot),
            pivot_keys=limbs_to_tensor(split_u64(self.pivot_keys), device),
            pivot_child=i32(self.pivot_child),
            leaf_anchor=limbs_to_tensor(split_u64(self.leaf_anchor), device),
            leaf_slope=f32(self.leaf_slope),
            leaf_count=i32(self.leaf_count),
            leaf_slot=i32(self.leaf_slot),
            leaf_next=i32(self.leaf_next),
            hbm_keys=limbs_to_tensor(split_u64(self.hbm_keys), device),
            hbm_vals=limbs_to_tensor(split_u64(self.hbm_vals), device),
        )

    # -- accounting (Table 1) ----------------------------------------------
    def index_bytes(self) -> int:
        """NIC-side bytes of the index structure (nodes + pivots + leaf meta),
        counting only *live* entries, with the paper's on-NIC field widths."""
        live_nodes = self.node_nseg.shape[0] - len(self.free_nodes)
        live_pivots = self.pivot_keys.shape[0] - len(self.free_pivots)
        live_leaves = self.leaf_anchor.shape[0] - len(self.free_leaves)
        node_bytes = live_nodes * (NODE_SEGS * (8 + 8 + 4 + 4) + 8)
        pivot_bytes = live_pivots * SEG_CAP * (8 + 4)
        leaf_bytes = live_leaves * (8 + 8 + 4 + 4 + 4 + self.cfg.ib_cap * 17)
        return node_bytes + pivot_bytes + leaf_bytes

    def data_bytes(self) -> int:
        n = int(self.leaf_count.sum())
        return n * 16  # 64-bit key + 64-bit value


# ---------------------------------------------------------------------------
# bulk loading (Sec 3.2.4): PLA-partition sorted pairs bottom-up on the host
# ---------------------------------------------------------------------------


def _round_pool(n: int, growth: float, minimum: int = 8) -> int:
    return max(minimum, int(np.ceil(n * growth / 8.0)) * 8)


def build_image(
    keys: np.ndarray,
    vals: np.ndarray,
    cfg: TreeConfig = TreeConfig(),
    pool_caps: Optional[Tuple[int, int, int, int]] = None,
) -> TreeImage:
    """Bulk-load a host tree image from sorted unique u64 keys + u64 values.

    Mirrors Sec 3.2.4: leaf level = PLA segments at eps_leaf; upper levels are
    built from the children's first keys with eps_inner, packed 7 segments per
    node, until a single node remains.
    """
    keys = np.asarray(keys, dtype=np.uint64)
    vals = np.asarray(vals, dtype=np.uint64)
    assert keys.ndim == 1 and keys.shape == vals.shape
    assert bool(np.all(keys[1:] > keys[:-1])), "keys must be sorted unique"

    if keys.size == 0:
        # empty bulk load (e.g. a hash shard that received no keys): one
        # empty leaf anchored at 0 keeps routing total; inserts fill it.
        leaf_segs = [pla.Segment(0, 0, np.uint64(0), 0.0)]
    else:
        leaf_segs = pla.fit(keys, cfg.eps_leaf, SEG_CAP)
    n_leaves = len(leaf_segs)

    # ---- build upper levels over first keys ------------------------------
    level_firsts = np.array([s.anchor for s in leaf_segs], dtype=np.uint64)
    levels: List[List[Tuple[pla.Segment, int]]] = []  # per level: (seg, node id base later)
    level_child_firsts = [level_firsts]
    level_segs: List[List[pla.Segment]] = []
    while level_child_firsts[-1].size > 1 or not level_segs:
        firsts = level_child_firsts[-1]
        segs = pla.fit(firsts, cfg.eps_inner, SEG_CAP)
        level_segs.append(segs)
        n_nodes = (len(segs) + NODE_SEGS - 1) // NODE_SEGS
        node_firsts = np.array(
            [firsts[segs[i * NODE_SEGS].start] for i in range(n_nodes)],
            dtype=np.uint64,
        )
        level_child_firsts.append(node_firsts)
        if n_nodes == 1:
            break

    total_nodes = sum(
        (len(s) + NODE_SEGS - 1) // NODE_SEGS for s in level_segs
    )
    total_pivot_slots = sum(len(s) for s in level_segs)

    if pool_caps is None:
        cap_leaves = _round_pool(n_leaves, cfg.growth, minimum=64)
        cap_slots = _round_pool(n_leaves, cfg.growth, minimum=64)
        # node/pivot minimums scale with the leaf pool: when churn grows the
        # leaf level toward cap_leaves, the inner levels must be able to
        # follow (batched flush cycles also hold obsoleted node rows in
        # epoch quarantine across a cycle, which needs transient headroom)
        cap_nodes = _round_pool(
            total_nodes, cfg.growth, minimum=max(32, cap_leaves // 32)
        )
        cap_pivots = _round_pool(
            total_pivot_slots, cfg.growth, minimum=max(64, cap_leaves // 8)
        )
    else:
        cap_nodes, cap_pivots, cap_leaves, cap_slots = pool_caps

    img = TreeImage(
        cfg=cfg,
        depth=len(level_segs) + 1,
        root=-1,
        node_nseg=np.zeros(cap_nodes, dtype=np.int32),
        node_seg_first=np.full((cap_nodes, NODE_SEGS), KEY_MAX, dtype=np.uint64),
        node_seg_slope=np.zeros((cap_nodes, NODE_SEGS), dtype=np.float64),
        node_seg_count=np.zeros((cap_nodes, NODE_SEGS), dtype=np.int32),
        node_seg_slot=np.full((cap_nodes, NODE_SEGS), -1, dtype=np.int32),
        pivot_keys=np.full((cap_pivots, SEG_CAP), KEY_MAX, dtype=np.uint64),
        pivot_child=np.full((cap_pivots, SEG_CAP), -1, dtype=np.int32),
        leaf_anchor=np.full(cap_leaves, KEY_MAX, dtype=np.uint64),
        leaf_slope=np.zeros(cap_leaves, dtype=np.float64),
        leaf_count=np.zeros(cap_leaves, dtype=np.int32),
        leaf_slot=np.full(cap_leaves, -1, dtype=np.int32),
        leaf_next=np.full(cap_leaves, -1, dtype=np.int32),
        leaf_prev=np.full(cap_leaves, -1, dtype=np.int32),
        hbm_keys=np.full((cap_slots, SEG_CAP), KEY_MAX, dtype=np.uint64),
        hbm_vals=np.zeros((cap_slots, SEG_CAP), dtype=np.uint64),
        free_nodes=list(range(cap_nodes - 1, -1, -1)),
        free_pivots=list(range(cap_pivots - 1, -1, -1)),
        free_leaves=list(range(cap_leaves - 1, -1, -1)),
        free_slots=list(range(cap_slots - 1, -1, -1)),
    )

    # ---- materialize leaves ----------------------------------------------
    leaf_ids = []
    for seg in leaf_segs:
        leaf = img.alloc("leaves")
        slot = img.alloc("slots")
        img.leaf_anchor[leaf] = seg.anchor
        img.leaf_slope[leaf] = seg.slope
        img.leaf_count[leaf] = seg.count
        img.leaf_slot[leaf] = slot
        img.hbm_keys[slot, : seg.count] = keys[seg.start : seg.start + seg.count]
        img.hbm_vals[slot, : seg.count] = vals[seg.start : seg.start + seg.count]
        leaf_ids.append(leaf)
    for a, b in zip(leaf_ids, leaf_ids[1:]):
        img.leaf_next[a] = b
        img.leaf_prev[b] = a

    # ---- materialize inner levels bottom-up ------------------------------
    child_ids = np.array(leaf_ids, dtype=np.int32)
    child_firsts = level_firsts
    for segs in level_segs:
        node_ids = []
        for i in range(0, len(segs), NODE_SEGS):
            node = img.alloc("nodes")
            group = segs[i : i + NODE_SEGS]
            img.node_nseg[node] = len(group)
            for j, seg in enumerate(group):
                slot = img.alloc("pivots")
                img.node_seg_first[node, j] = seg.anchor
                img.node_seg_slope[node, j] = seg.slope
                img.node_seg_count[node, j] = seg.count
                img.node_seg_slot[node, j] = slot
                sl = slice(seg.start, seg.start + seg.count)
                img.pivot_keys[slot, : seg.count] = child_firsts[sl]
                img.pivot_child[slot, : seg.count] = child_ids[sl]
            node_ids.append(node)
        child_ids = np.array(node_ids, dtype=np.int32)
        child_firsts = np.array(
            [img.node_seg_first[n, 0] for n in node_ids], dtype=np.uint64
        )
    img.root = int(child_ids[0]) if img.depth > 1 else leaf_ids[0]
    return img
