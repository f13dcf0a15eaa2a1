"""Epoch-consistent, shard-count-independent store snapshots — a copy of
the JAX package's ``distributed/snapshot.py`` over the port's checkpoint
manager (same on-disk layout: a snapshot written by either package restores
in the other).

The paper's host-side maintenance path already produces the right
serialization unit: ``extract_slice`` / ``snapshot_slice`` ship a store as
*ordered leaf runs* — ascending ``(keys, vals)`` pairs with no index state
attached, because the learned index is cheap enough to rebuild at load
time (the HiStore hybrid-index argument).  A whole-store snapshot is just
the global ordered run plus the routing metadata the fleet planner needs
(boundary vector, boundary epoch, replica layout), and precisely because
the run carries no shard structure it restores onto ANY shard count: the
reader refits quantile boundaries for its own fleet
(``pla.fit_boundaries``) and bulk-loads each slice — the levanter-style
mesh-independent checkpoint idiom applied to a KV store.

Epoch consistency is free on this codebase: the host facade serializes
waves, so ``items()`` — which flushes nothing but folds staged insert
buffers over the stitched census, clipped to each shard's owned window
under the *current* boundary epoch — is a consistent cut even mid-handoff
(donor stale copies are invisible to the census exactly as they are to
new-epoch waves).

On disk a snapshot is a ``checkpoint.CheckpointManager`` step — the same
atomic-commit directory layout (``step_*.tmp`` -> ``os.replace``) the
training-state checkpoints use — holding a flat dict of arrays (flatten
order of a dict is its sorted keys, so reader and writer agree without a
schema file).  ``CheckpointManager.restore_arrays`` reads it back without
knowing any shapes up front: the writer may have run at a different shard
count than the reader.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import numpy as np

from ..checkpoint.manager import CheckpointManager
from ..core.tree import TreeConfig

_PARTITION_CODES = {"single": 0, "hash": 1, "range": 2}
_PARTITION_NAMES = {v: k for k, v in _PARTITION_CODES.items()}


@dataclass(frozen=True)
class StoreSnapshot:
    """A loaded snapshot: the global ordered run + fleet metadata."""

    keys: np.ndarray  # ascending u64 live keys (the ordered leaf run)
    vals: np.ndarray  # matching u64 values
    partition: str  # "single" | "hash" | "range" (writer's layout — advisory)
    n_shards: int  # writer's shard count (advisory: restore at any count)
    replication: int  # writer's replica count (advisory)
    boundary_epoch: int  # writer's ownership epoch at the cut
    boundaries: Optional[np.ndarray]  # writer's boundary vector (advisory)
    primary: Optional[np.ndarray]  # writer's primary map (advisory)
    in_sync: Optional[np.ndarray]  # writer's in-sync matrix (advisory)

    @property
    def n_keys(self) -> int:
        return int(self.keys.size)


def snapshot_state(store) -> dict:
    """The flat array dict a snapshot persists.  ``store`` is anything
    speaking the ``KVStore`` protocol (``DPAStore``, ``ShardedDPAStore``,
    or the pipelined facade — whose ``items()`` passthrough is a pipeline
    barrier, giving the epoch-consistent cut)."""
    keys, vals = store.items()
    partition = getattr(store, "partition", "single")
    n_shards = int(getattr(store, "n_shards", 1))
    replication = int(getattr(store, "replication", 1))
    ownership = getattr(store, "ownership", None)
    if ownership is not None:
        boundaries = np.asarray(ownership.current, dtype=np.uint64)
        epoch = int(ownership.epoch)
        primary = np.asarray(ownership.primary, dtype=np.int32)
        in_sync = np.asarray(ownership.in_sync, dtype=bool)
    else:
        boundaries = np.zeros(0, dtype=np.uint64)
        epoch = 0
        primary = np.zeros(n_shards, dtype=np.int32)
        in_sync = np.ones((n_shards, replication), dtype=bool)
    meta = np.array(
        [_PARTITION_CODES[partition], n_shards, replication, epoch],
        dtype=np.int64,
    )
    return {
        "boundaries": boundaries,
        "in_sync": in_sync,
        "keys": np.asarray(keys, dtype=np.uint64),
        "meta": meta,
        "primary": primary,
        "vals": np.asarray(vals, dtype=np.uint64),
    }


def save_snapshot(
    store, directory: Union[str, Path], step: int = 0, keep: int = 3
) -> int:
    """Write an epoch-consistent snapshot of ``store`` as checkpoint
    ``step`` under ``directory`` (atomic commit; blocking).  Returns the
    step written."""
    mgr = CheckpointManager(directory, keep=keep)
    mgr.save(step, snapshot_state(store), blocking=True)
    return step


def load_snapshot(
    directory: Union[str, Path], step: Optional[int] = None
) -> StoreSnapshot:
    """Read a snapshot back (default: the latest committed step) without
    assuming anything about the writer's shard count."""
    mgr = CheckpointManager(directory)
    if step is None:
        step = mgr.latest_step()
        assert step is not None, f"no committed snapshot under {directory}"
    meta, leaves = mgr.restore_arrays(step)
    # flatten order of a flat dict == sorted keys
    boundaries, in_sync, keys, meta_arr, primary, vals = leaves
    part_code, n_shards, replication, epoch = (int(x) for x in meta_arr)
    partition = _PARTITION_NAMES[part_code]
    return StoreSnapshot(
        keys=keys,
        vals=vals,
        partition=partition,
        n_shards=n_shards,
        replication=replication,
        boundary_epoch=epoch,
        boundaries=boundaries if partition == "range" else None,
        primary=primary,
        in_sync=in_sync,
    )


def restore_store(
    snap: Union[StoreSnapshot, str, Path],
    n_shards: Optional[int] = None,
    tree_cfg: TreeConfig = TreeConfig(),
    partition: Optional[str] = None,
    replication: Optional[int] = None,
    device=None,
    **store_kwargs,
):
    """Build a fresh store from a snapshot at ANY shard count.

    ``n_shards=0`` (or a ``partition`` of ``"single"``) builds a plain
    ``DPAStore``; otherwise a ``ShardedDPAStore`` whose quantile
    boundaries are refit over the snapshot's keys for the NEW shard count
    — the snapshot's own boundary vector is advisory only, which is the
    whole point of the shard-count-independent layout.  Defaults follow
    the writer's layout.  The store is built on ``device`` (the card unless
    the caller passes ``device="cpu"``)."""
    from ..core.store import DPAStore
    from .kvshard import ShardedDPAStore

    if not isinstance(snap, StoreSnapshot):
        snap = load_snapshot(snap)
    if partition is None:
        partition = snap.partition
    if n_shards is None:
        n_shards = snap.n_shards if partition != "single" else 0
    if replication is None:
        replication = snap.replication if partition == "range" else 1
    if n_shards == 0 or partition == "single":
        assert replication == 1, "a single store has no replica groups"
        return DPAStore(snap.keys, snap.vals, tree_cfg, device=device, **store_kwargs)
    return ShardedDPAStore(
        snap.keys,
        snap.vals,
        n_shards,
        tree_cfg,
        partition=partition,
        replication=replication,
        device=device,
        **store_kwargs,
    )
