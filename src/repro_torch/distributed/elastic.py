"""Elastic scaling: re-mesh planning + restart contract (a copy of the JAX
package's ``distributed/elastic.py`` over the port's ``configs.base``).

The checkpoint layout is mesh-independent (full logical arrays), so scaling
is: pick the new mesh -> recompute shardings -> restore -> continue.  This
module owns the "pick the new mesh" part and the invariants that make the
restart exact:

  * global batch stays fixed (per-host batch changes) so the loss
    trajectory is unchanged;
  * the data pipeline is step-indexed, so re-slicing is a pure function of
    (step, shard, n_shards);
  * model-axis size must keep dividing the sharded dims — candidate meshes
    are filtered accordingly.

KV replica recovery (:func:`plan_replica_remesh`) is the same planning
discipline applied to the replicated KV tier: given which replicas of each
shard group are alive, decide what to rebuild and from where — each dead
slot re-replicates from its group's primary (or the lowest-indexed
survivor) via ``snapshot_slice``/``ingest_slice``, and a group with no
survivor is an unrecoverable loss the plan refuses to paper over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..configs.base import ArchConfig


@dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def candidate_meshes(n_devices: int) -> List[MeshPlan]:
    """(data, model) factorisations, model <= 64 (TP beyond one pod's worth
    of fast links is never worth it)."""
    out = []
    m = 1
    while m <= min(64, n_devices):
        if n_devices % m == 0:
            out.append(MeshPlan((n_devices // m, m), ("data", "model")))
        m *= 2
    return out


def plan_remesh(
    cfg: ArchConfig,
    n_devices: int,
    global_batch: int,
    prefer_model: Optional[int] = None,
) -> MeshPlan:
    """Choose the mesh for a changed device count.

    Constraints: model axis must divide d_ff / head counts actually sharded;
    data axis must divide the global batch.  Preference: keep the model axis
    as before (minimises resharding traffic), else the largest feasible.
    """

    def ok(plan: MeshPlan) -> bool:
        data, model = plan.shape
        if global_batch % data != 0:
            return False
        if cfg.d_ff and cfg.d_ff % model != 0:
            return False
        if cfg.n_heads and cfg.n_heads % model != 0:
            return False
        if cfg.vocab_size % model != 0:
            return False
        return True

    cands = [p for p in candidate_meshes(n_devices) if ok(p)]
    if not cands:
        raise ValueError(f"no feasible mesh for {n_devices} devices")
    if prefer_model is not None:
        for p in cands:
            if p.shape[1] == prefer_model:
                return p
    return max(cands, key=lambda p: p.shape[1])


@dataclass(frozen=True)
class ReplicaRebuild:
    """One dead replica slot and the live replica that re-seeds it."""

    group: int  # shard group index
    replica: int  # dead slot to rebuild
    source: int  # live slot whose snapshot_slice feeds ingest_slice


@dataclass(frozen=True)
class ReplicaRemeshPlan:
    n_groups: int
    n_replicas: int
    rebuilds: Tuple[ReplicaRebuild, ...]

    @property
    def n_rebuilds(self) -> int:
        return len(self.rebuilds)


def plan_replica_remesh(
    n_groups: int,
    n_replicas: int,
    alive: Sequence[Sequence[bool]],
    primaries: Optional[Sequence[int]] = None,
) -> ReplicaRemeshPlan:
    """Plan re-replication after replica failures.

    ``alive[g][r]`` says whether replica ``r`` of group ``g`` still holds a
    usable copy.  Each dead slot is rebuilt from its group's primary when
    the primary survived, else from the lowest-indexed survivor — one full
    ``snapshot_slice`` read per rebuild, so the plan also bounds recovery
    traffic.  A group with zero survivors has lost data no plan can
    recover; that is an error, not a silent empty rebuild.
    """
    alive_m = np.asarray(alive, dtype=bool)
    if alive_m.shape != (n_groups, n_replicas):
        raise ValueError(
            f"alive must be ({n_groups}, {n_replicas}), got {alive_m.shape}"
        )
    rebuilds: List[ReplicaRebuild] = []
    for g in range(n_groups):
        survivors = np.where(alive_m[g])[0]
        if survivors.size == 0:
            raise ValueError(f"group {g} has no surviving replica: data loss")
        source = int(survivors[0])
        if primaries is not None and alive_m[g, int(primaries[g])]:
            source = int(primaries[g])
        for r in range(n_replicas):
            if not alive_m[g, r]:
                rebuilds.append(ReplicaRebuild(group=g, replica=r, source=source))
    return ReplicaRemeshPlan(
        n_groups=n_groups, n_replicas=n_replicas, rebuilds=tuple(rebuilds)
    )


def restart_report(old_devices: int, new_devices: int, plan: MeshPlan) -> dict:
    return {
        "old_devices": old_devices,
        "new_devices": new_devices,
        "mesh": {"shape": plan.shape, "axes": plan.axes},
        "contract": [
            "restore checkpoint (mesh-independent layout)",
            "recompute param/opt shardings for the new mesh",
            "data pipeline re-slices by (step, shard, n_shards)",
            "global batch unchanged -> identical loss trajectory",
        ],
    }
