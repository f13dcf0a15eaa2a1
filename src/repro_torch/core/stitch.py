"""Stitch command streams — how host-side tree changes reach the device tree
(Sec 3.2.2 / Figures 6-7).  PyTorch port of the JAX package's
``core/stitch.py``.

  * **COPY** commands write fully-formed new rows into *free* pool rows.
    The host has pre-computed every destination id, so applying copies
    allocates nothing and touches nothing reachable from the current root.
  * **CONNECT** commands are the pointer swaps that make the copies visible:
    a parent pivot_child entry, a leaf_next link, or the root id.  They are
    applied strictly after all copies of the batch.

A merged flush-cycle batch can target one row more than once.  COPYs are
coalesced to the last write per row and CONNECTs deduped last-wins per
pointer before the scatter, so every scatter here writes unique indices:
the result is the stream order's on the CPU and on CUDA alike (a duplicate
CUDA scatter has no defined winner).  The device pools are updated in
place; the JAX package builds new arrays.

``payload_bytes()`` is the number of bytes that must move host -> device
for the batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .keys import limbs_to_tensor, split_u64
from .lookup import InsertBuffers
from .tree import DeviceTree, NODE_SEGS, SEG_CAP
from . import insert_buffer


@dataclass
class StitchBatch:
    """One patch (or one merged flush cycle): COPY rows per pool + CONNECT
    pointer swaps.  COPYs accumulate as (idx, row) items and are coalesced
    into per-pool scatter arrays on demand — O(1) per append instead of the
    O(n^2) concat-per-row a growing merged batch would otherwise pay."""

    # COPY — pool name -> list of (row index, row payload) in numpy.
    # Pools: node_nseg, node_seg_first(u64), node_seg_slope, node_seg_count,
    #        node_seg_slot, pivot_keys(u64), pivot_child, leaf_anchor(u64),
    #        leaf_slope, leaf_count, leaf_slot, leaf_next,
    #        hbm_keys(u64), hbm_vals(u64)
    copies: Dict[str, List[Tuple[int, np.ndarray]]] = field(default_factory=dict)
    # CONNECT — list of ("pivot_child", slot, pos, child) |
    #           ("leaf_next", leaf, next) | ("root", node_id, depth)
    connects: List[tuple] = field(default_factory=list)
    # leaves whose insert buffers this patch consumed (cleared at connect time)
    clear_ib: List[int] = field(default_factory=list)
    # pool rows that become garbage once the connect is visible (epoch-freed)
    frees: List[Tuple[str, int]] = field(default_factory=list)
    # pure value updates (no structure change): (slot, values-row u64)
    value_updates: List[Tuple[int, np.ndarray]] = field(default_factory=list)
    # memoized coalesced_copies() (computed once per apply; a transaction's
    # byte accounting reuses it) — invalidated by add_copy
    _cc: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = field(
        default=None, repr=False, compare=False
    )

    def add_copy(self, pool: str, idx: int, row: np.ndarray) -> None:
        self.copies.setdefault(pool, []).append((int(idx), np.asarray(row)))
        self._cc = None

    def coalesced_copies(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """Per-pool (ids (n,), rows (n, ...)) scatter arrays.  Duplicate row
        writes (a merged cycle re-patching a row it created) keep the last
        payload, matching sequential application order."""
        if self._cc is not None:
            return self._cc
        out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for pool, items in self.copies.items():
            last: Dict[int, np.ndarray] = {}
            for idx, row in items:
                last[idx] = row
            ids = np.fromiter(last.keys(), dtype=np.int32, count=len(last))
            rows = np.stack([np.asarray(r) for r in last.values()], axis=0)
            out[pool] = (ids, rows)
        self._cc = out
        return out

    def coalesced_value_updates(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(slots (n,), value rows (n, SEG_CAP) u64), last write per slot."""
        if not self.value_updates:
            return None
        last: Dict[int, np.ndarray] = {}
        for slot, vals in self.value_updates:
            last[int(slot)] = vals
        slots = np.fromiter(last.keys(), dtype=np.int32, count=len(last))
        rows = np.stack([np.asarray(v, dtype=np.uint64) for v in last.values()])
        return slots, rows

    def payload_bytes(self) -> int:
        """All bytes the batch moves (host writes + host->DPA stitches)."""
        return self.dpa_bytes() + self.host_bytes()

    def dpa_bytes(self) -> int:
        """Bytes crossing the host->DPA-memory path — the 120 MB/s bottleneck
        of Secs 4.2.7/4.2.8.  Only NIC-resident pools count: nodes, pivots,
        leaf metadata.  Leaf key/value arrays live in host memory in the
        paper ("for leaves, only model parameters and DMA addresses are
        transferred"), so hbm_* copies and value updates are host-local."""
        total = 0
        for pool, (ids, rows) in self.coalesced_copies().items():
            if pool.startswith("hbm_"):
                continue
            total += rows.size * rows.dtype.itemsize + ids.size * 4
        total += 16 * len(self.connects)
        return total

    def host_bytes(self) -> int:
        """Host-memory-local bytes (leaf data writes + value updates)."""
        total = 0
        for pool, (ids, rows) in self.coalesced_copies().items():
            if pool.startswith("hbm_"):
                total += rows.size * rows.dtype.itemsize + ids.size * 4
        for _, vals in self.value_updates:
            total += vals.size * vals.dtype.itemsize + 8
        return total


_U64_POOLS = {
    "node_seg_first",
    "pivot_keys",
    "leaf_anchor",
    "hbm_keys",
    "hbm_vals",
}
_F32_POOLS = {"node_seg_slope", "leaf_slope"}


def _payload(pool: str, rows: np.ndarray, device) -> torch.Tensor:
    if pool in _U64_POOLS:
        return limbs_to_tensor(split_u64(rows.astype(np.uint64)), device)
    if pool in _F32_POOLS:
        return torch.from_numpy(np.asarray(rows, dtype=np.float32)).to(device)
    return torch.from_numpy(np.asarray(rows, dtype=np.int32)).to(device)


def apply_copies(tree: DeviceTree, batch: StitchBatch) -> DeviceTree:
    """Write COPY rows into free pool rows, in place — one indexed write per
    pool, however many patches the batch merged.  Old tree stays fully
    reachable."""
    dev = tree.hbm_keys.device
    for pool, (ids, rows) in batch.coalesced_copies().items():
        # node_nseg has no device twin: segment count is implied by KEY_MAX
        # padding in node_seg_first; skip it.
        if pool == "node_nseg":
            continue
        arr = getattr(tree, pool)
        arr[torch.from_numpy(ids.astype(np.int64)).to(dev)] = _payload(pool, rows, dev)
    vu = batch.coalesced_value_updates()
    if vu is not None:
        slots, rows = vu
        tree.hbm_vals[torch.from_numpy(slots.astype(np.int64)).to(dev)] = _payload(
            "hbm_vals", rows, dev
        )
    return tree


def apply_connects(
    tree: DeviceTree, ib: InsertBuffers, batch: StitchBatch
) -> Tuple[DeviceTree, InsertBuffers]:
    """Flip the pointers — the visibility point of the whole patch.
    Duplicate targets keep the last value, which is what applying them in
    stream order would produce."""
    dev = tree.hbm_keys.device
    pivot_swaps: Dict[Tuple[int, int], int] = {}
    next_swaps: Dict[int, int] = {}
    root: Optional[int] = None

    for c in batch.connects:
        kind = c[0]
        if kind == "pivot_child":
            _, slot, pos, child = c
            pivot_swaps[(int(slot), int(pos))] = int(child)
        elif kind == "leaf_next":
            _, leaf, nxt = c
            next_swaps[int(leaf)] = int(nxt)
        elif kind == "root":
            _, node, _depth = c
            root = int(node)
        else:  # pragma: no cover - defensive
            raise ValueError(f"unknown connect {kind}")

    def t(values):
        return torch.tensor(list(values), dtype=torch.int64, device=dev)

    if pivot_swaps:
        tree.pivot_child[t(k[0] for k in pivot_swaps), t(k[1] for k in pivot_swaps)] = t(
            pivot_swaps.values()
        ).to(torch.int32)
    if next_swaps:
        tree.leaf_next[t(next_swaps.keys())] = t(next_swaps.values()).to(torch.int32)
    if root is not None:
        tree = tree._replace(root=torch.tensor(root, dtype=torch.int32, device=dev))
    if batch.clear_ib:
        ib = insert_buffer.clear_rows(ib, t(batch.clear_ib))
    return tree, ib


def bulk_load_batch(img) -> StitchBatch:
    """The bulk-load stitch stream (Sec 3.2.4): COPY every live row, one final
    root CONNECT.  Used both to assemble the initial device tree and to
    measure bulk-load payload bytes for the 120 MB/s bandwidth model."""
    batch = StitchBatch()
    live_nodes = sorted(set(range(img.node_nseg.shape[0])) - set(img.free_nodes))
    live_pivots = sorted(set(range(img.pivot_keys.shape[0])) - set(img.free_pivots))
    live_leaves = sorted(set(range(img.leaf_anchor.shape[0])) - set(img.free_leaves))
    live_slots = sorted(set(range(img.hbm_keys.shape[0])) - set(img.free_slots))
    for n in live_nodes:
        batch.add_copy("node_seg_first", n, img.node_seg_first[n])
        batch.add_copy("node_seg_slope", n, img.node_seg_slope[n])
        batch.add_copy("node_seg_count", n, img.node_seg_count[n])
        batch.add_copy("node_seg_slot", n, img.node_seg_slot[n])
    for p in live_pivots:
        batch.add_copy("pivot_keys", p, img.pivot_keys[p])
        batch.add_copy("pivot_child", p, img.pivot_child[p])
    for l in live_leaves:
        batch.add_copy("leaf_anchor", l, np.uint64(img.leaf_anchor[l]))
        batch.add_copy("leaf_slope", l, np.float64(img.leaf_slope[l]))
        batch.add_copy("leaf_count", l, np.int32(img.leaf_count[l]))
        batch.add_copy("leaf_slot", l, np.int32(img.leaf_slot[l]))
        batch.add_copy("leaf_next", l, np.int32(img.leaf_next[l]))
    for s in live_slots:
        batch.add_copy("hbm_keys", s, img.hbm_keys[s])
        batch.add_copy("hbm_vals", s, img.hbm_vals[s])
    batch.connects.append(("root", img.root, img.depth))
    return batch


def empty_device_tree(img, device) -> DeviceTree:
    """Pool-shaped empty device tree (pre-bulk-load state)."""
    cap_nodes = img.node_nseg.shape[0]
    cap_pivots = img.pivot_keys.shape[0]
    cap_leaves = img.leaf_anchor.shape[0]
    cap_slots = img.hbm_keys.shape[0]
    pad = -1  # 0xFFFFFFFF limbs: KEY_MAX
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return DeviceTree(
        root=torch.tensor(-1, **i32),
        node_seg_first=torch.full((cap_nodes, NODE_SEGS, 2), pad, **i32),
        node_seg_slope=torch.zeros((cap_nodes, NODE_SEGS), **f32),
        node_seg_count=torch.zeros((cap_nodes, NODE_SEGS), **i32),
        node_seg_slot=torch.full((cap_nodes, NODE_SEGS), -1, **i32),
        pivot_keys=torch.full((cap_pivots, SEG_CAP, 2), pad, **i32),
        pivot_child=torch.full((cap_pivots, SEG_CAP), -1, **i32),
        leaf_anchor=torch.full((cap_leaves, 2), pad, **i32),
        leaf_slope=torch.zeros((cap_leaves,), **f32),
        leaf_count=torch.zeros((cap_leaves,), **i32),
        leaf_slot=torch.full((cap_leaves,), -1, **i32),
        leaf_next=torch.full((cap_leaves,), -1, **i32),
        hbm_keys=torch.full((cap_slots, SEG_CAP, 2), pad, **i32),
        hbm_vals=torch.zeros((cap_slots, SEG_CAP, 2), **i32),
    )
