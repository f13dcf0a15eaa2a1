"""Online range-tier rebalancing: boundary refit planning + two-phase
slice-migration bookkeeping (a numpy copy of the JAX package's
``distributed/rebalance.py`` over the port's ``core.pla``).

Why this exists.  The range tier (``kvshard.ShardedDPAStore(partition=
"range")``) fixes its quantile boundaries at load time; a sustained skewed
insert storm then piles new keys into one or two edge shards, and the
scatter-gather RANGE advantage erodes into a single hot shard's throughput.
The paper's architecture already contains the cure: structural maintenance
runs on the *host* while the device keeps serving, and the stitch pipeline
ships contiguous leaf runs transactionally.  A live rebalance is exactly
that maintenance applied one level up — the partition map is just the
zero-parameter learned index over shards (``core.pla.fit_boundaries``), and
a slice migration is a leaf-run extract on the donor + a bulk ingest on the
receiver, both riding the existing batched patch/stitch machinery
(``core.store.extract_slice`` / ``ingest_slice``).

Two-phase ownership (the handoff epoch).  Flipping a boundary while waves
are in flight needs the same discipline a stitch CONNECT needs: a request
must be served by the ownership map it was *admitted* under.
:class:`OwnershipTable` therefore keeps TWO boundary vectors during a
migration:

  * ``begin_rebalance`` copies each moving slice into its receiver (the
    donor keeps serving it), then installs the new vector as the current
    epoch while retaining the old one — the *handoff* epoch.  Requests
    admitted from now on route by the new vector (the receiver owns the
    slice and has the copy); waves admitted earlier keep routing by the
    epoch they carry (``route(keys, epoch=...)`` — the host analogue of the
    paper's packet-counter epochs).
  * ``commit_rebalance`` runs after the old epoch's waves have drained:
    the donor's now-stale copy is extracted (a leaf-run of tombstones
    through the patch/stitch path, which also drops its scan anchors via
    ``EpochManager.on_defer``) and the old vector is retired.

During the handoff both shards physically hold the slice.  Point ops are
safe by routing (exactly one owner per epoch); RANGE is safe because every
shard's contribution is clipped to its *owned window* under the routing
epoch (host path in ``kvshard.ShardedDPAStore.range``, device path in
``rangeshard`` — successor sub-queries start at the shard's lower bound and
entries at/above its upper bound are dropped), so a stale copy outside a
shard's window is invisible even to a scatter-gather wave that lands on it.
Writes admitted during the handoff route to the new owner only; the donor's
retained copy is a snapshot of the pre-handoff state, which is exactly what
old-epoch readers are entitled to see.

Planning.  :class:`RebalancePlanner` watches per-shard load and occupancy,
keeps a reservoir sample of the observed key stream (loaded keys + inserts
— the streaming analogue of the load-time empirical CDF), and proposes a
refit (``pla.refit_boundaries``) when the occupancy spread crosses its
trigger.  :func:`plan_moves` turns an (old, new) boundary pair into ordered
:class:`SliceMove`\\ s: down-moves (slices shifting toward higher shards)
run left-to-right and up-moves right-to-left so cascaded moves — a slice
crossing more than one boundary in a single refit — see each intermediate
ingest before their own snapshot.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..core import pla


# ---------------------------------------------------------------------------
# two-phase ownership table
# ---------------------------------------------------------------------------


@dataclass
class OwnershipTable:
    """Boundary vectors by epoch: ``current`` always routes fresh requests;
    ``previous`` is retained only during a handoff so in-flight waves
    admitted under the old epoch can still be routed (and audited) by it.

    Replica sets.  With ``n_replicas > 1`` each range slice maps to a
    replica *group* — ``primary[g]`` names the replica serving as the
    group's primary (snapshot source, device-wave server) and
    ``in_sync[g, r]`` tracks which replicas hold every acknowledged write
    (writes fan out synchronously to the whole in-sync set, so any of them
    can serve reads).  The primary map is epoch-versioned exactly like the
    boundary vector: a primary failover is an :meth:`install` with a new
    primary map (boundaries unchanged), so in-flight waves admitted under
    the old epoch drain under the old map while fresh requests follow the
    promoted follower — the same two-epoch discipline a rebalance handoff
    rides."""

    current: np.ndarray  # (n_shards - 1,) u64 partition start keys
    epoch: int = 0
    previous: Optional[np.ndarray] = None
    # -- replica-set state (n_replicas == 1 degenerates to single-owner) --
    n_replicas: int = 1
    primary: Optional[np.ndarray] = None  # (n_shards,) i32 replica index
    previous_primary: Optional[np.ndarray] = None  # old epoch's map (handoff)
    in_sync: Optional[np.ndarray] = None  # (n_shards, n_replicas) bool
    previous_in_sync: Optional[np.ndarray] = None  # old epoch's set (reshard)

    def __post_init__(self) -> None:
        self.current = np.asarray(self.current, dtype=np.uint64)
        assert self.n_replicas >= 1
        n_shards = self.current.size + 1
        if self.primary is None:
            self.primary = np.zeros(n_shards, dtype=np.int32)
        else:
            self.primary = np.asarray(self.primary, dtype=np.int32)
        if self.in_sync is None:
            self.in_sync = np.ones((n_shards, self.n_replicas), dtype=bool)
        else:
            self.in_sync = np.asarray(self.in_sync, dtype=bool)

    @property
    def in_handoff(self) -> bool:
        return self.previous is not None

    def boundaries_for(self, epoch: Optional[int] = None) -> np.ndarray:
        """Boundary vector of ``epoch`` (default: current).  Only the
        current epoch and — during a handoff — its predecessor are live;
        anything older has been retired and raises ``KeyError`` (a wave
        that old must have drained before the previous commit)."""
        if epoch is None or epoch == self.epoch:
            return self.current
        if epoch == self.epoch - 1 and self.previous is not None:
            return self.previous
        raise KeyError(
            f"boundary epoch {epoch} retired (current={self.epoch}, "
            f"handoff={'yes' if self.in_handoff else 'no'})"
        )

    def route(self, keys_u64: np.ndarray, epoch: Optional[int] = None) -> np.ndarray:
        """Owner shard per key under the given epoch's boundaries
        (bit-identical to the device boundary search)."""
        b = self.boundaries_for(epoch)
        return np.searchsorted(
            b, np.asarray(keys_u64, dtype=np.uint64), side="right"
        ).astype(np.int32)

    def install(
        self,
        new_boundaries: Optional[np.ndarray] = None,
        new_primary: Optional[np.ndarray] = None,
    ) -> int:
        """Begin a handoff epoch: the new boundary vector and/or primary
        map become current, the old pair stays live for exactly one epoch
        (``None`` keeps the corresponding vector unchanged — a primary
        failover flips only the map, a rebalance only the boundaries).

        A ``new_boundaries`` vector of a *different length* is a reshard:
        the shard count itself flips with the epoch.  The primary map and
        in-sync matrix are rebuilt for the new shard count (every fresh
        group starts fully in-sync — the reshard path builds each new
        group complete before installing) while the old epoch's maps stay
        readable via ``primary_for`` / ``previous_in_sync`` until
        :meth:`retire_previous`.  Returns the new epoch."""
        assert not self.in_handoff, "commit the previous rebalance first"
        assert new_boundaries is not None or new_primary is not None
        self.previous = self.current
        self.previous_primary = self.primary.copy()
        self.previous_in_sync = self.in_sync.copy()
        if new_boundaries is not None:
            new_boundaries = np.asarray(new_boundaries, dtype=np.uint64)
            assert np.all(
                new_boundaries[1:] >= new_boundaries[:-1]
            ), "boundaries must be sorted"
            if new_boundaries.shape != self.current.shape:  # reshard
                n_new = new_boundaries.size + 1
                if new_primary is None:
                    new_primary = np.zeros(n_new, dtype=np.int32)
                self.in_sync = np.ones((n_new, self.n_replicas), dtype=bool)
                self.primary = np.zeros(n_new, dtype=np.int32)
            self.current = new_boundaries
        if new_primary is not None:
            new_primary = np.asarray(new_primary, dtype=np.int32)
            assert new_primary.shape == self.primary.shape
            assert np.all((new_primary >= 0) & (new_primary < self.n_replicas))
            assert self.in_sync[
                np.arange(new_primary.size), new_primary
            ].all(), "a primary must be in-sync"
            self.primary = new_primary
        self.epoch += 1
        return self.epoch

    def retire_previous(self) -> None:
        """End the handoff: the old epoch's waves have drained."""
        self.previous = None
        self.previous_primary = None
        self.previous_in_sync = None

    # -- replica sets ------------------------------------------------------
    def primary_for(self, epoch: Optional[int] = None) -> np.ndarray:
        """(n_shards,) primary replica per group under ``epoch`` (default:
        current) — same liveness rule as :meth:`boundaries_for`."""
        if epoch is None or epoch == self.epoch:
            return self.primary
        if epoch == self.epoch - 1 and self.previous_primary is not None:
            return self.previous_primary
        raise KeyError(
            f"primary-map epoch {epoch} retired (current={self.epoch}, "
            f"handoff={'yes' if self.in_handoff else 'no'})"
        )

    def replica_set(self, group: int) -> np.ndarray:
        """In-sync replica indices of ``group`` — any of them may serve
        reads (synchronous fan-out keeps them bitwise content-equal)."""
        return np.where(self.in_sync[group])[0]

    def fail_replica(self, group: int, replica: int) -> Optional[int]:
        """Mark ``replica`` of ``group`` dead (out of sync).  Killing the
        group's primary additionally installs a failover epoch promoting
        the lowest-indexed in-sync follower (two-epoch discipline: callers
        drain old-epoch waves, then :meth:`retire_previous`).  Returns the
        promoted replica index, or ``None`` when a follower died (no epoch
        flip needed — it simply drops out of the read set).  Raises
        ``RuntimeError`` when the group's last in-sync replica dies (the
        slice is unrecoverable without external state)."""
        assert 0 <= replica < self.n_replicas
        self.in_sync[group, replica] = False
        survivors = self.replica_set(group)
        if survivors.size == 0:
            raise RuntimeError(
                f"group {group} lost its last in-sync replica — slice data "
                "is unrecoverable (raise n_replicas)"
            )
        if replica != int(self.primary_for()[group]):
            return None
        assert not self.in_handoff, (
            "primary failover during an open rebalance handoff: drain and "
            "retire the rebalance epoch first"
        )
        new_primary = self.primary.copy()
        new_primary[group] = int(survivors[0])
        self.install(new_primary=new_primary)
        return int(survivors[0])

    def restore_replica(self, group: int, replica: int) -> None:
        """Re-admit a recovered replica to the in-sync set.  The caller
        must have made it content-complete first (bootstrap via the
        primary's ``snapshot_slice`` before any further write is admitted
        — the host facade serializes waves, so there is no window)."""
        assert 0 <= replica < self.n_replicas
        self.in_sync[group, replica] = True

    # -- owned-window bounds (for RANGE contribution clipping) -------------
    def lower_bounds(self, epoch: Optional[int] = None) -> np.ndarray:
        """(n_shards,) u64 inclusive lower bound of each shard's slice."""
        b = self.boundaries_for(epoch)
        return np.concatenate([np.zeros(1, dtype=np.uint64), b])

    def upper_bounds(self, epoch: Optional[int] = None) -> np.ndarray:
        """(n_shards,) u64 exclusive upper bound; the last shard's bound is
        the reserved KEY_MAX sentinel (no real key reaches it)."""
        from ..core.keys import KEY_MAX

        b = self.boundaries_for(epoch)
        return np.concatenate([b, np.full(1, KEY_MAX, dtype=np.uint64)])


# ---------------------------------------------------------------------------
# migration plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SliceMove:
    """One contiguous slice ``[k_lo, k_hi)`` migrating donor -> receiver
    (always adjacent shards; ``boundary`` is the moved vector index)."""

    boundary: int
    donor: int
    receiver: int
    k_lo: int  # inclusive
    k_hi: int  # exclusive

    @property
    def width(self) -> int:
        return self.k_hi - self.k_lo


def plan_moves(old_b: np.ndarray, new_b: np.ndarray) -> List[SliceMove]:
    """Slice moves implied by an (old, new) boundary pair, in an order that
    makes cascades sound.

    Boundary ``i`` is the start key of shard ``i+1``.  Moving it *up*
    (``new > old``) grows shard ``i`` by ``[old, new)`` — donor ``i+1``,
    receiver ``i``; moving it *down* grows shard ``i+1`` by ``[new, old)``
    — donor ``i``, receiver ``i+1``.  Down-moves are emitted left-to-right
    and up-moves right-to-left: when adjacent boundaries move past each
    other's old positions, a slice hops through the intermediate shard, and
    this order guarantees the intermediate ingest lands before the
    dependent snapshot (both vectors are sorted, so the dependency only
    ever points that way).
    """
    old_b = np.asarray(old_b, dtype=np.uint64)
    new_b = np.asarray(new_b, dtype=np.uint64)
    assert old_b.shape == new_b.shape
    downs = [
        SliceMove(i, donor=i, receiver=i + 1, k_lo=int(new_b[i]), k_hi=int(old_b[i]))
        for i in range(old_b.size)
        if new_b[i] < old_b[i]
    ]
    ups = [
        SliceMove(i, donor=i + 1, receiver=i, k_lo=int(old_b[i]), k_hi=int(new_b[i]))
        for i in reversed(range(old_b.size))
        if new_b[i] > old_b[i]
    ]
    return downs + ups


# ---------------------------------------------------------------------------
# streaming key sample
# ---------------------------------------------------------------------------


class ReservoirSample:
    """Fixed-capacity uniform sample of the observed key stream (algorithm
    R, vectorized): the empirical-CDF input of the online refit.  Seeded ->
    deterministic, so a rebalance decision is reproducible from the op
    trace alone."""

    def __init__(self, capacity: int, seed: int = 0):
        assert capacity >= 1
        self.capacity = capacity
        self._rng = np.random.default_rng(seed)
        self._buf = np.zeros(capacity, dtype=np.uint64)
        self._fill = 0
        self.n_seen = 0

    def observe(self, keys_u64: np.ndarray) -> None:
        keys = np.asarray(keys_u64, dtype=np.uint64).ravel()
        if keys.size == 0:
            return
        take = min(self.capacity - self._fill, keys.size)
        if take:
            self._buf[self._fill : self._fill + take] = keys[:take]
            self._fill += take
            self.n_seen += take
            keys = keys[take:]
        if keys.size:
            # element t of the stream replaces a random slot with prob cap/t
            t = self.n_seen + np.arange(1, keys.size + 1)
            slots = self._rng.integers(0, t)
            hit = slots < self.capacity
            self._buf[slots[hit]] = keys[hit]
            self.n_seen += keys.size

    def snapshot(self) -> np.ndarray:
        """Sorted copy of the current sample."""
        return np.sort(self._buf[: self._fill].copy())


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RebalanceConfig:
    sample_size: int = 4096  # reservoir capacity (the streaming CDF)
    spread_trigger: float = 1.4  # max/mean occupancy ratio that arms a refit
    min_total_keys: int = 512  # below this a refit cannot pay for itself
    damping: float = 1.0  # fraction of each boundary's quantile move to take
    seed: int = 0
    # Chain-compaction trigger: a sweep (``compact_chain``, which also
    # physically reclaims TTL-expired keys via ``ttl_sweep``) is proposed
    # once this many empty leaf stubs have accumulated across the tier.
    compact_stub_trigger: int = 8


class RebalancePlanner:
    """Watches per-shard load/occupancy and proposes boundary refits.

    ``observe`` feeds the reservoir (bulk-loaded keys at construction,
    inserted keys per wave); ``note_load`` accumulates the per-shard request
    counters the facade's router already computes.  ``should_rebalance``
    triggers on *occupancy* spread — the quantity a refit provably fixes;
    load spread is surfaced in :meth:`stats` for the benchmarks but a
    read-hot shard with balanced occupancy is the hot cache's job, not a
    migration's."""

    def __init__(self, cfg: RebalanceConfig, n_shards: int):
        self.cfg = cfg
        self.n_shards = n_shards
        self.sample = ReservoirSample(cfg.sample_size, seed=cfg.seed)
        self.load = np.zeros(n_shards, dtype=np.int64)

    def observe(self, keys_u64: np.ndarray) -> None:
        self.sample.observe(keys_u64)

    def note_load(self, dest: np.ndarray) -> None:
        self.load += np.bincount(
            np.asarray(dest, dtype=np.int64), minlength=self.n_shards
        )

    @staticmethod
    def spread(occupancy: np.ndarray) -> float:
        """max/mean occupancy ratio (1.0 = perfectly balanced)."""
        occ = np.asarray(occupancy, dtype=np.float64)
        mean = occ.mean() if occ.size else 0.0
        return float(occ.max() / mean) if mean > 0 else 1.0

    def should_rebalance(self, occupancy: np.ndarray) -> bool:
        occ = np.asarray(occupancy, dtype=np.int64)
        if int(occ.sum()) < self.cfg.min_total_keys:
            return False
        return self.spread(occ) >= self.cfg.spread_trigger

    def should_compact(self, stub_count: int) -> bool:
        """Arm a chain-compaction sweep once enough empty leaf stubs (the
        residue of deletion storms and TTL expiry) have piled up to pay for
        the patch-cycle it costs."""
        return int(stub_count) >= self.cfg.compact_stub_trigger

    def propose(self, current: np.ndarray) -> np.ndarray:
        """New boundary vector from the streaming sample (damped toward the
        fresh quantiles per the config)."""
        return pla.refit_boundaries(
            self.sample.snapshot(),
            self.n_shards,
            old=current,
            damping=self.cfg.damping,
        )

    def stats(self) -> Dict[str, float]:
        return {
            "sample_fill": int(self.sample._fill),
            "keys_seen": int(self.sample.n_seen),
            "load_spread": self.spread(self.load) if self.load.sum() else 1.0,
        }
