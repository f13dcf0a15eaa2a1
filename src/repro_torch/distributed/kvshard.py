"""Distributed DPA-Store: request routing across shards — the PyTorch port
of the JAX package's ``distributed/kvshard.py``.

The paper steers requests to DPA threads by key hash (UDP port selection).
Scaled out, the same pattern shards the store:

  clients -> partition(key) -> exchange -> owner shard's
  traversal (hot cache -> learned index -> leaf) -> exchange back

Each shard owns an independent sub-store (its own tree pools, insert
buffers, caches) covering its slice of the key space — clients stay
stateless (routing is a pure function of the key).  Two partitions share
the routing/exchange machinery:

  * ``partition="hash"`` — ``hash(key) % n_shards``, the paper's UDP
    steering scaled out.  Point ops route to exactly one shard; RANGE
    cannot be routed and must broadcast (the non-scalable baseline).
  * ``partition="range"`` — quantile boundaries over the loaded keys
    (``core.pla.fit_boundaries``): each shard owns a contiguous key slice,
    so RANGE scatter-gathers to the owner shard and its successors only
    (``repro_torch.distributed.rangeshard`` holds the device wave).

The exchange uses fixed per-shard-pair capacity with overflow -> RETRY
status, the batched analogue of the paper's receive-queue overflow handling
(Sec 3.1.3).

On the range tier each shard can be a *replica group* (``replication=R``):
R bitwise-identical sub-stores per key slice, one of them primary.  Writes
fan out synchronously to every in-sync replica (ack = durable everywhere),
reads round-robin over the in-sync set, and killing the primary promotes a
follower through the same two-epoch ownership flip the rebalance handoff
uses — see ``ShardedDPAStore.kill_replica`` / ``recover_replicas``.

Everything but ``serve_wave_sharded`` runs on one device.
:class:`ShardedDPAStore` is host orchestration over per-shard
``DPAStore`` s (every sub-store on the facade's ``device``: the card unless
the caller passes ``device="cpu"``), so each shard's GET and RANGE
sub-waves run on kernels B1-B3 through the store.  ``serve_wave_emulated`` is the device wave over ``stacked()``: the
reference ``vmap`` s it over the shard dim; here it is a loop over shards
whose exchange is a transpose of the ``(src, dest, cap)`` bucket tensor,
and each destination shard serves its requests with kernel B1
(``kernels.ops.get``) on its slice of the stacked pools.  Not-found rows
carry 0 (B1's contract; the reference's plain ``get_batch`` leaves the
probed slot there).

``serve_wave_sharded`` is the same wave over ranks: each rank of a mesh's
``data`` axis (``launch.mesh``) holds one shard's pools and its own
request rows, runs ``make_serve_wave``'s body once (B1 once per rank a
wave), and the exchange is ``torch.distributed.all_to_all_single`` over the
axis's process group (:class:`MeshExchange`).  On one card the ranks share
it over ``gloo``; ``launch.local_ranks`` spawns them.

JAX drops scatter writes at out-of-range indices (``mode="drop"``); torch
raises on the CPU and is undefined on CUDA.  Every such scatter here writes
into one scratch row past the end, which is sliced away.  The in-range
indices of each scatter are unique (ranks within a bucket, origins within a
wave), so no duplicate-winner rule is needed.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import api, lookup, pla
from ..core.api import RangeResult
from ..core.epoch import EpochRetiredError
from ..core.keys import KEY_MAX, limb_hash, limb_hash_np, u32
from ..core.lookup import InsertBuffers
from ..core.scancache import ScanCacheConfig
from ..core.spans import SpanTable, span, sum_totals
from ..core.store import STATUS_OK, DPAStore
from ..core.tree import DeviceTree, TreeConfig
from ..core.ttl import TTLTracker
from ..device import resolve_device
from ..kernels import ops
from ..launch.mesh import data_axis
from .elastic import plan_replica_remesh
from .rebalance import OwnershipTable, RebalanceConfig, RebalancePlanner, plan_moves

SALT_SHARD = 11


def shard_of(khi, klo, n_shards: int):
    """Owner shard per request (int32-held limbs -> int32).  The hash is a
    u32 value; the modulo is taken on it widened to int64, never on its
    int32 bit pattern (a signed ``%`` would move every hash with its top
    bit set to another shard)."""
    return (limb_hash(u32(khi), u32(klo), SALT_SHARD) % n_shards).to(torch.int32)


def shard_of_np(keys_u64: np.ndarray, n_shards: int) -> np.ndarray:
    """Client-side routing hash (bit-identical to the device path)."""
    return (limb_hash_np(np.asarray(keys_u64, dtype=np.uint64), SALT_SHARD) % n_shards).astype(
        np.int32
    )


def append_range_results(keys_out, vals_out, counts, idxs, rk, rv, rc, limit):
    """The scatter-gather epilogue's stitch: append each row's first
    ``take`` results at its current fill level.  ``idxs`` maps the
    sub-batch rows of ``rk``/``rv``/``rc`` to rows of the accumulators;
    mutates them in place and returns the per-row appended counts."""
    cols = np.arange(limit)
    take = np.minimum(rc, limit - counts[idxs])
    src = cols[None, :] < take[:, None]  # (k, limit)
    dst_col = counts[idxs][:, None] + cols[None, :]
    dst_row = np.repeat(idxs, take)
    keys_out[dst_row, dst_col[src]] = rk[src]
    vals_out[dst_row, dst_col[src]] = rv[src]
    counts[idxs] += take
    return take


def _pad_stack(arrs):
    """Stack per-shard pool tensors, zero-padding every dim to the max shape
    so the shard dim can be treated uniformly."""
    if arrs[0].ndim == 0:
        return torch.stack(arrs)
    shape = tuple(max(a.shape[i] for a in arrs) for i in range(arrs[0].ndim))
    out = torch.zeros((len(arrs), *shape), dtype=arrs[0].dtype, device=arrs[0].device)
    for s, a in enumerate(arrs):
        out[(s, *(slice(0, n) for n in a.shape))] = a
    return out


def stack_shards(stores) -> Tuple[DeviceTree, InsertBuffers, int]:
    """Stack per-shard device trees + insert buffers along a leading shard
    dim (pool shapes padded to the max).  Returns (tree, ib, depth); all
    shards must have equal depth for the lockstep traversal.  The stack is
    a copy of every serving store's pools."""
    tree_t = type(stores[0].tree)
    stacked_tree = tree_t(
        **{
            f: _pad_stack([getattr(st.tree, f) for st in stores])
            for f in tree_t._fields
        }
    )
    ib_t = type(stores[0].ib)
    stacked_ib = ib_t(
        **{
            f: _pad_stack([getattr(st.ib, f) for st in stores])
            for f in ib_t._fields
        }
    )
    depth = max(st.depth for st in stores)
    assert all(st.depth == depth for st in stores), "equalise shard sizes"
    return stacked_tree, stacked_ib, depth


def stacked_bytes(stacked_tree, stacked_ib) -> int:
    """Device bytes of a ``stack_shards`` copy."""
    return sum(t.numel() * t.element_size() for t in (*stacked_tree, *stacked_ib))


def shard_state(stacked_tree, stacked_ib, s: int) -> Tuple[DeviceTree, InsertBuffers]:
    """Shard ``s``'s tree and insert buffers: views of its slice of the
    stacked pools (contiguous, so the kernels read them in place)."""
    return (
        type(stacked_tree)(*(f[s] for f in stacked_tree)),
        type(stacked_ib)(*(f[s] for f in stacked_ib)),
    )

class _ShardGetWave(NamedTuple):
    """In-flight sharded GET: one sub-wave per touched shard."""

    n: int
    parts: List  # (shard, row mask, serving store, _GetWave)


class _ShardWriteWave(NamedTuple):
    """In-flight sharded fast-path write: one sub-wave per (shard, replica)
    of the synchronous fan-out — only built once EVERY member's plan probe
    proved the wave lands (a mid-batch fallback would double-apply the
    already-issued members)."""

    n: int
    parts: List  # (shard, row mask, replica store, _WriteWave)


class _ShardRangeWave(NamedTuple):
    """In-flight sharded RANGE: the speculative scatter (issue) plus the
    host accumulators the ordered gather stitches into (finalize)."""

    n: int
    limit: int
    max_leaves: int
    mode: str  # "range" | "hash"
    empty: bool
    keys_out: np.ndarray
    vals_out: np.ndarray
    counts: np.ndarray
    parts: List  # range: (shard, cand idxs, sub_start, sub_ub, store, _RangeWave)
    #              hash:  (shard, None, None, None, store, _RangeWave)


class ShardedDPAStore:
    """Multi-shard DPA-Store facade: routes client batches to per-shard
    sub-stores and drains each shard's staged writes through the *batched*
    patch/stitch pipeline — one merged stitch transaction per shard per
    flush cycle, the scaled-out version of Sec 3.2's batching.

    ``partition`` selects the routing function:

    * ``"hash"`` (default) — ``hash(key) % n_shards``.  Point ops route to
      one shard; :meth:`range` must broadcast to every shard and k-way merge
      (kept as the non-scalable baseline the paper's ordered store exists to
      avoid).
    * ``"range"`` — quantile boundaries fitted over the loaded keys
      (``core.pla.fit_boundaries``); every shard owns a contiguous key
      slice, so :meth:`range` scatter-gathers over the owner shard and its
      successors only.  Boundaries are *live*: a ``RebalancePlanner``
      samples the key stream and, when the occupancy spread crosses its
      trigger, :meth:`rebalance` refits them online and migrates the
      implied slices between neighbouring shards through the batched
      patch/stitch pipeline.  The flip is two-phase
      (``distributed.rebalance.OwnershipTable``): :meth:`begin_rebalance`
      copies each slice to its receiver and installs the new boundary
      vector while the old one stays live for one epoch (in-flight waves
      route by the epoch they were admitted under); :meth:`commit_rebalance`
      retires the donors' stale copies once those waves have drained.

    ``replication=R`` (range tier only) turns each shard into a *replica
    group* of R bitwise-identical sub-stores over the same key slice.
    Writes fan out synchronously to every in-sync replica and the returned
    status is the pessimistic merge, so status OK means the write is
    durable on the whole group — the zero-lost-acked-writes guarantee the
    failover test holds the store to.  Reads (GET and RANGE sub-queries)
    round-robin over the in-sync set; a RANGE sub-query pins its replica
    for the whole continuation loop (resume cursors are store-local).
    :meth:`kill_replica` crashes a replica; killing the primary installs a
    failover epoch via ``OwnershipTable.install(new_primary=...)`` — the
    boundary vector is unchanged, so both epochs route identically and
    in-flight waves drain under the epoch they were admitted with.
    :meth:`recover_replicas` re-replicates dead slots from each group's
    primary (``elastic.plan_replica_remesh`` → ``snapshot_slice`` +
    ``ingest_slice``/bulk load).

    This is host-side orchestration (each shard is an independent
    ``DPAStore``); the device-resident wave paths are
    ``serve_wave_emulated`` over ``stacked()`` for GET and
    ``rangeshard.range_wave_emulated`` for RANGE.

    Every sub-store lives on ``device`` (the card unless the caller passes
    ``device="cpu"``).
    """

    def __init__(
        self,
        keys: np.ndarray,
        vals: np.ndarray,
        n_shards: int,
        tree_cfg: TreeConfig = TreeConfig(),
        cache_cfg=None,
        batched_patch: bool = True,
        partition: str = "hash",
        scan_cache_cfg="default",
        rebalance_cfg="default",
        replication: int = 1,
        watchdog=None,
        retain_epochs: int = 0,
        device=None,
    ):
        assert partition in ("hash", "range"), partition
        assert n_shards >= 1, f"n_shards must be positive, got {n_shards}"
        assert replication >= 1, f"replication must be positive, got {replication}"
        assert partition == "range" or replication == 1, (
            "replication rides the range tier's epoch-versioned OwnershipTable"
        )
        keys = np.asarray(keys, dtype=np.uint64)
        vals = np.asarray(vals, dtype=np.uint64)
        self.n_shards = n_shards
        self.cfg = tree_cfg
        self.device = resolve_device(device)
        self.partition = partition
        self.replication = replication
        if partition == "range":
            self.ownership = OwnershipTable(
                pla.fit_boundaries(keys, n_shards), n_replicas=replication
            )
            if rebalance_cfg == "default":
                rebalance_cfg = RebalanceConfig()
            self.planner = (
                RebalancePlanner(rebalance_cfg, n_shards)
                if rebalance_cfg is not None
                else None
            )
            if self.planner is not None:
                self.planner.observe(keys)  # load-time sample seed
        else:
            self.ownership = None
            self.planner = None
        self._pending_moves = []
        # reshard handoff: the pre-flip generation of shard groups (a
        # DIFFERENT group count than ``self.groups``), kept alive so waves
        # admitted under the old boundary epoch stay routable until
        # ``commit_reshard`` retires them wholesale
        self._retired_groups: Optional[List[List[Optional["DPAStore"]]]] = None
        self._reshard_keys_pending = 0
        # rebalance accounting
        self.rebalances = 0
        self.rebalances_aborted = 0
        self.migrated_keys = 0
        # elastic accounting
        self.reshards = 0
        self.resharded_keys = 0
        self.evacuations = 0
        # straggler watchdog: per-shard drain seconds (the per-shard
        # decomposition of the pipeline WaveLedger's drain phase) feed
        # ``watchdog.observe``; ``wave_time_hook(shard, seconds) -> seconds``
        # lets tests and chaos drills inject a slow host deterministically
        self.watchdog = watchdog
        self.wave_time_hook = None
        self.shard_drain_ns = np.zeros(n_shards, dtype=np.int64)
        # the facade's own host spans (routing); each sub-store keeps its own
        self.spans = SpanTable()
        h = self.route_np(keys)
        # scatter-gather accounting (benchmarks report the measured fan-out
        # and the continuation re-issue traffic)
        self.range_requests = 0
        self.range_subqueries = 0
        self.range_reissues = 0
        # replication accounting (fig19: write amplification, failover)
        self.client_writes = 0
        self.replica_writes = 0
        self.acked_writes = 0
        self.failovers = 0
        self.recoveries = 0
        self._read_rr = 0  # round-robin cursor over in-sync replicas
        if scan_cache_cfg == "default":
            scan_cache_cfg = ScanCacheConfig()  # per-shard anchor caches
        self._store_kwargs = dict(
            cache_cfg=cache_cfg,
            batched_patch=batched_patch,
            scan_cache_cfg=scan_cache_cfg,
            retain_epochs=retain_epochs,
            device=self.device,
        )
        # Shared TTL sidecar: deadlines are keyed by KEY, not by store, so
        # one tracker serves every replica and generation — a key's deadline
        # survives slice migration, replica recovery and reshard without any
        # copy step.  Every store this facade creates gets this tracker
        # (see _make_store); per-shard sweeps are therefore facade-level
        # only (ttl_sweep routes the tombstones).
        self.retain_epochs = retain_epochs
        self.ttl = TTLTracker()
        # facade point-in-time snapshots: seq -> pinned stores/epochs/routing
        self._snap_seq = 0
        self._snaps: Dict[int, Dict] = {}
        # groups[s][r]: replica r of shard group s (None = crashed slot).
        # R identical bulk loads, so replicas start bitwise-equal and the
        # synchronous write fan-out keeps their contents that way.
        self.groups: List[List[Optional[DPAStore]]] = [
            [self._make_store(keys[h == s], vals[h == s]) for _ in range(replication)]
            for s in range(n_shards)
        ]

    def _make_store(self, keys: np.ndarray, vals: np.ndarray):
        st = DPAStore(keys, vals, self.cfg, **self._store_kwargs)
        st.ttl = self.ttl  # shared deadline sidecar (see __init__)
        return st

    def _fresh_store_with(self, k: np.ndarray, v: np.ndarray):
        """Fresh store holding exactly ``(k, v)``: ingest into an empty
        store when headroom allows (the patch/stitch path), bulk load
        otherwise — the recovery/reshard/evacuation build discipline."""
        empty = np.empty(0, dtype=np.uint64)
        fresh = self._make_store(empty, empty)
        if k.size and k.size <= fresh.ingest_headroom():
            fresh.ingest_slice(k, v)
        elif k.size:  # slice exceeds an empty store's free pools
            fresh = self._make_store(k, v)
        return fresh

    @property
    def shards(self) -> List:
        """Current-epoch primary of each shard group (the pre-replication
        single-store-per-shard view; R=1 callers see exactly the old list)."""
        if self.ownership is None:
            return [g[0] for g in self.groups]
        pm = self.ownership.primary
        return [self.groups[s][int(pm[s])] for s in range(self.n_shards)]

    def _in_sync(self, s: int) -> List[int]:
        if self.ownership is None:
            return [0]
        return [int(r) for r in self.ownership.replica_set(s)]

    def _groups_for_epoch(self, epoch: Optional[int]):
        """The shard-group generation serving ``epoch``.  Only a reshard
        handoff keeps two generations alive (their group COUNTS differ);
        every other handoff routes both epochs over ``self.groups``."""
        if (
            epoch is not None
            and self._retired_groups is not None
            and self.ownership is not None
            and epoch == self.ownership.epoch - 1
        ):
            return self._retired_groups
        return self.groups

    def _read_store(self, s: int, epoch: Optional[int] = None):
        """Pick the replica that serves this read: round-robin over the
        in-sync set (every member is content-identical, so the choice is
        invisible in results — it only spreads load).  During a reshard
        handoff an old-epoch read lands on the retired generation, whose
        in-sync set is the old epoch's (``previous_in_sync``)."""
        groups = self._groups_for_epoch(epoch)
        if groups is not self.groups:
            ins = self.ownership.previous_in_sync
            replicas = [int(r) for r in np.where(ins[s])[0]]
        else:
            replicas = self._in_sync(s)
        pick = replicas[self._read_rr % len(replicas)]
        self._read_rr += 1
        return groups[s][pick]

    def _note_shard_time(self, s: int, seconds: float) -> None:
        """Feed one shard's drain time into the straggler ledger (and the
        watchdog, when armed).  ``s < 0`` marks a retired-generation
        sub-wave — the old host set is being decommissioned, not
        monitored."""
        if s < 0:
            return
        if self.wave_time_hook is not None:
            seconds = float(self.wave_time_hook(s, seconds))
        self.shard_drain_ns[s] += int(seconds * 1e9)
        if self.watchdog is not None:
            self.watchdog.observe(s, seconds)

    def _wave_end(self) -> None:
        """Close one watchdog step: strike counters advance exactly once
        per client wave (GET/PUT/DELETE/RANGE), matching the per-step
        semantics the straggler EWMA is calibrated for."""
        if self.watchdog is not None:
            self.watchdog.end_step()

    def _write_group(
        self, s: int, op: str, keys: np.ndarray, *arrays,
        auto_retry: bool = True, **kw,
    ) -> np.ndarray:
        """Fan one write batch out to every in-sync replica of group ``s``.
        Statuses merge pessimistically (max: OK=0 < RETRY) — a key is acked
        only once every replica holds it.  Extra kwargs (``ttl=``) pass
        through; each replica's ``note_put`` hits the SAME shared tracker
        with the same deadline, so the fan-out is idempotent there."""
        status = None
        for r in self._in_sync(s):
            st = getattr(self.groups[s][r], op)(
                keys, *arrays, auto_retry=auto_retry, **kw
            )
            self.replica_writes += int(keys.size)
            status = st if status is None else np.maximum(status, st)
        return status

    @property
    def boundaries(self) -> Optional[np.ndarray]:
        """Current-epoch boundary vector (None on the hash tier)."""
        return self.ownership.current if self.ownership is not None else None

    @property
    def boundary_epoch(self) -> int:
        return self.ownership.epoch if self.ownership is not None else 0

    @property
    def in_handoff(self) -> bool:
        return self.ownership is not None and self.ownership.in_handoff

    @property
    def in_reshard(self) -> bool:
        """True between :meth:`begin_reshard` and :meth:`commit_reshard`
        (the handoff whose two epochs have different shard counts)."""
        return self._retired_groups is not None

    def boundaries_for_epoch(self, epoch: Optional[int] = None) -> np.ndarray:
        assert self.ownership is not None, "range tier only"
        return self.ownership.boundaries_for(epoch)

    def route_np(
        self, keys_u64: np.ndarray, epoch: Optional[int] = None
    ) -> np.ndarray:
        """Owner shard per key (client-side; bit-identical to the device
        routing of the matching wave path).  On the range tier ``epoch``
        selects the boundary vector a request wave was admitted under
        (default: current) — during a rebalance handoff both the current
        and the previous epoch are routable."""
        keys_u64 = np.asarray(keys_u64, dtype=np.uint64)
        if self.partition == "range":
            return self.ownership.route(keys_u64, epoch=epoch)
        if epoch is not None:
            # NOT an assert: request validation must survive ``python -O``
            raise ValueError(
                "hash routing has no boundary epochs (epoch must be None)"
            )
        return shard_of_np(keys_u64, self.n_shards)

    def _route(self, keys_u64: np.ndarray, epoch: Optional[int] = None):
        keys_u64 = np.asarray(keys_u64, dtype=np.uint64)
        dest = self.route_np(keys_u64, epoch=epoch)
        # the load counter is indexed by CURRENT shards — a reshard handoff
        # makes old-epoch destinations a different width, and the retiring
        # hosts' load is not the new planner's business anyway
        current = (
            epoch is None
            or self.ownership is None
            or epoch == self.ownership.epoch
        )
        if self.planner is not None and keys_u64.size and current:
            self.planner.note_load(dest)
        return keys_u64, dest

    def _route_masks(self, keys_u64, n: int, epoch: Optional[int] = None):
        """``_route`` and each of the ``n`` shards' row mask, timed as the
        span ``kv/shard/route``."""
        with span(self.spans, "kv/shard/route"):
            keys_u64, dest = self._route(keys_u64, epoch=epoch)
            return keys_u64, [dest == s for s in range(n)]

    def span_totals(self) -> Dict[str, Tuple[int, int]]:
        """Host spans summed over the live stores (as ``stats_totals``)
        plus the facade's own: ``name -> (ns, calls)``."""
        return sum_totals([st.span_totals() for st in self._live_stores()] + [self.spans.totals()])

    def put(
        self, keys=None, vals=None, *,
        auto_retry: bool = True, ttl: Optional[int] = None, **legacy,
    ) -> np.ndarray:
        keys = api.take_legacy("put", legacy, keys, "keys", "keys_u64")
        vals = api.take_legacy("put", legacy, vals, "vals", "vals_u64")
        api.reject_unknown("put", legacy)
        if self.planner is not None:
            # feed the streaming key sample the online refit fits against
            self.planner.observe(np.asarray(keys, dtype=np.uint64))
        keys, masks = self._route_masks(keys, self.n_shards)
        vals = np.asarray(vals, dtype=np.uint64)
        statuses = np.zeros(keys.size, dtype=np.int32)
        for s, m in enumerate(masks):
            if m.any():
                t0 = time.perf_counter()
                statuses[m] = self._write_group(
                    s, "put", keys[m], vals[m], auto_retry=auto_retry, ttl=ttl
                )
                self._note_shard_time(s, time.perf_counter() - t0)
        self._wave_end()
        self.client_writes += int(keys.size)
        self.acked_writes += int((statuses == STATUS_OK).sum())
        return statuses

    def delete(self, keys=None, *, auto_retry: bool = True, **legacy) -> np.ndarray:

        keys = api.take_legacy("delete", legacy, keys, "keys", "keys_u64")
        api.reject_unknown("delete", legacy)
        keys, masks = self._route_masks(keys, self.n_shards)
        statuses = np.zeros(keys.size, dtype=np.int32)
        for s, m in enumerate(masks):
            if m.any():
                t0 = time.perf_counter()
                statuses[m] = self._write_group(
                    s, "delete", keys[m], auto_retry=auto_retry
                )
                self._note_shard_time(s, time.perf_counter() - t0)
        self._wave_end()
        self.client_writes += int(keys.size)
        self.acked_writes += int((statuses == STATUS_OK).sum())
        return statuses

    def get(
        self,
        keys=None,
        *,
        epoch: Optional[int] = None,
        as_of: Optional[int] = None,
        **legacy,
    ) -> Tuple[np.ndarray, np.ndarray]:
        keys = api.take_legacy("get", legacy, keys, "keys", "keys_u64")
        api.reject_unknown("get", legacy)
        if as_of is not None:
            if epoch is not None:
                # NOT an assert: must survive ``python -O``
                raise ValueError(
                    "get: as_of (version epoch) and epoch (routing epoch) "
                    "are mutually exclusive"
                )
            return self._get_as_of(np.asarray(keys, dtype=np.uint64), as_of)
        return self.get_finalize(self.get_issue(keys, epoch=epoch))

    def get_issue(self, keys, *, epoch: Optional[int] = None) -> _ShardGetWave:
        """Issue half of the sharded GET: route, then dispatch one async
        sub-wave on each touched shard's serving replica.  The routing
        epoch is captured here — barrier ops (rebalance install, failover
        flip) drain the pipeline first, so ownership cannot move under an
        in-flight wave.  ``get() == get_finalize(get_issue())``."""
        groups = self._groups_for_epoch(epoch)
        keys, masks = self._route_masks(np.asarray(keys, dtype=np.uint64), len(groups), epoch=epoch)
        track = groups is self.groups  # retired generation: not monitored
        parts = []
        for s, m in enumerate(masks):
            if m.any():
                st = self._read_store(s, epoch=epoch)
                parts.append((s if track else -1, m, st, st.get_issue(keys[m])))
        return _ShardGetWave(n=keys.size, parts=parts)

    def get_finalize(self, w: _ShardGetWave) -> Tuple[np.ndarray, np.ndarray]:
        vals = np.zeros(w.n, dtype=np.uint64)
        found = np.zeros(w.n, dtype=bool)
        for s, m, st, sub in w.parts:
            t0 = time.perf_counter()
            v, f = st.get_finalize(sub)
            self._note_shard_time(s, time.perf_counter() - t0)
            vals[m] = v
            found[m] = f
        self._wave_end()
        return vals, found

    # ---------------------------------------------- async write fast path
    def write_issue(self, op: str, keys, vals=None) -> Optional[_ShardWriteWave]:
        """Issue half of sharded PUT/DELETE.  Probes ``_write_plan`` on
        EVERY in-sync replica of every touched group before a single lane
        is issued: either the whole fan-out is proven to land (then every
        member dispatches asynchronously) or the method returns ``None``
        with zero side effects and the caller drains + falls back to the
        serial path.  Mid-batch fallback is thereby impossible — the
        already-issued members of a partial wave could not be un-applied."""
        assert op in ("put", "delete"), op
        keys = np.asarray(keys, dtype=np.uint64)
        vals_np = None if vals is None else np.asarray(vals, dtype=np.uint64)
        with span(self.spans, "kv/shard/route"):
            dest = self.route_np(keys)
            masks = [dest == s for s in range(self.n_shards)]
        plans = []
        for s, m in enumerate(masks):
            if not m.any():
                continue
            for r in self._in_sync(s):
                if self.groups[s][r]._write_plan(keys[m]) is None:
                    return None
            plans.append((s, m))
        # committed: feed the planner exactly as the serial path would
        # (skipped on fallback so the serial retry is the one that feeds it)
        if self.planner is not None and op == "put":
            self.planner.observe(keys)
        if self.planner is not None and keys.size:
            self.planner.note_load(dest)
        parts = []
        for s, m in plans:
            sub_vals = None if vals_np is None else vals_np[m]
            for r in self._in_sync(s):
                sub = self.groups[s][r].write_issue(op, keys[m], sub_vals)
                assert sub is not None, "issue diverged from its plan probe"
                self.replica_writes += int(m.sum())
                parts.append((s, m, self.groups[s][r], sub))
        self.client_writes += int(keys.size)
        return _ShardWriteWave(n=keys.size, parts=parts)

    def write_finalize(self, w: _ShardWriteWave) -> np.ndarray:

        statuses = np.zeros(w.n, dtype=np.int32)
        for s, m, st, sub in w.parts:
            t0 = time.perf_counter()
            sub_status = st.write_finalize(sub)
            self._note_shard_time(s, time.perf_counter() - t0)
            # pessimistic merge (max: OK=0 < RETRY), same as _write_group
            statuses[m] = np.maximum(statuses[m], sub_status)
        self._wave_end()
        self.acked_writes += int((statuses == STATUS_OK).sum())
        return statuses

    def range(
        self,
        k_min=None,
        limit: int = 10,
        *args,
        k_max=None,
        epoch: Optional[int] = None,
        as_of: Optional[int] = None,
        max_leaves: int = 4,
        fanout: Optional[int] = None,
        **legacy,
    ):
        """Batched RANGE(k_min, limit) -> :class:`repro_torch.core.api.RangeResult`
        (tuple-unpackable as the legacy ``(keys (n, limit), vals (n, limit),
        count (n,))``) — globally ascending live entries, zeros past
        ``count``, clipped to ``[k_min, k_max)`` when ``k_max`` (scalar or
        per-row, exclusive) is given.

        Range partition: scatter-gather with in-mesh continuation.  Each
        request is sent to its owner shard (boundary search) and then to
        successive shards — at most ``fanout`` of them (default: all) and
        only while the request still needs results.  A shard serves its
        whole sub-query in ONE dispatch: ``range_with_state`` drives the
        multi-round ``max_leaves`` walk inside a device loop
        (``lookup.range_batch_loop``), re-walking only truncated lanes from
        their cursor and clipping every round to the shard's owned window
        ``[lb, ub)`` — so the steady-state path performs ZERO host
        re-issues (``range_reissues`` stays 0; interior rounds are counted
        by ``range_rounds_in_mesh``).  The host fallback — resuming a row
        from its returned cursor — survives only for the rare case of a
        bounded device loop (chain-length hard cap).  Results are exact for
        any ``max_leaves`` >= 1; each shard's first descent per sub-query
        goes through its scan-anchor cache.

        ``epoch`` selects the boundary epoch the wave was admitted under
        (default: current) — during a rebalance handoff both epochs are
        live, and routing, window lower bounds AND the per-round upper
        clip all follow the admitted epoch, which is what keeps a donor's
        not-yet-retired stale slice copy invisible and makes mid-migration
        RANGE bitwise-equal to the oracle under either epoch (mirrors the
        epoch-tagged ``rangeshard`` device waves).

        Hash partition: keys are scattered by hash, so every shard must scan
        (broadcast) and the epilogue k-way merges — correct, but aggregate
        RANGE throughput cannot exceed one shard's.  This is the baseline
        ``benchmarks/fig16_range.py`` plots against the range tier.
        """
        k_min = api.take_legacy("range", legacy, k_min, "k_min", "start_keys_u64")
        api.reject_unknown("range", legacy)
        if args:  # legacy positional (max_leaves, fanout, epoch)
            api.warn_legacy(
                "range", "positional tuning arguments", "max_leaves=/fanout=/epoch="
            )
            for name, val in zip(("max_leaves", "fanout", "epoch"), args):
                if name == "max_leaves":
                    max_leaves = val
                elif name == "fanout":
                    fanout = val
                else:
                    epoch = val
        if as_of is not None:
            if epoch is not None:
                # NOT an assert: must survive ``python -O``
                raise ValueError(
                    "range: as_of (version epoch) and epoch (routing epoch) "
                    "are mutually exclusive"
                )
            return self._range_as_of(
                k_min, limit, k_max=k_max, max_leaves=max_leaves,
                fanout=fanout, as_of=as_of,
            )
        start = np.asarray(k_min, dtype=np.uint64)
        n = start.size
        keys_out = np.zeros((n, max(limit, 0)), dtype=np.uint64)
        vals_out = np.zeros((n, max(limit, 0)), dtype=np.uint64)
        counts = np.zeros(n, dtype=np.int64)
        if n == 0 or limit <= 0:
            return RangeResult(keys_out, vals_out, counts)
        self.range_requests += n
        if k_max is not None:  # per-row exclusive clip (scalar broadcasts)
            k_max = np.broadcast_to(np.asarray(k_max, dtype=np.uint64), (n,))
        if self.partition == "range":
            with span(self.spans, "kv/shard/route"):
                owner = self.route_np(start, epoch=epoch)
            lb = self.ownership.lower_bounds(epoch)
            ub = self.ownership.upper_bounds(epoch)  # KEY_MAX sentinel last
            groups = self._groups_for_epoch(epoch)
            track = groups is self.groups
            n_eff = len(groups)  # old-epoch waves see the OLD fleet width
            fanout = n_eff if fanout is None else fanout
            for s in range(n_eff):
                m = (owner <= s) & (s - owner < fanout) & (counts < limit)
                if not m.any():
                    continue
                self.range_subqueries += int(m.sum())
                idxs = np.where(m)[0]
                # owned-window lower bound (successor sub-queries scan from
                # their slice start; no-op for the owner by routing)
                sub_start = np.maximum(start[idxs], lb[s])
                # the owned-window upper clip, tightened per row by the
                # request's own k_max when given
                sub_ub = np.full(idxs.size, ub[s], dtype=np.uint64)
                if k_max is not None:
                    sub_ub = np.minimum(sub_ub, k_max[idxs])
                resume = None
                # pin one in-sync replica for the whole continuation loop:
                # resume cursors (cur_leaf) are store-local leaf ids
                serving = self._read_store(s, epoch=epoch)
                t0 = time.perf_counter()
                while idxs.size:
                    rk, rv, rc, trunc, cur_leaf, _ = serving.range_with_state(
                        sub_start,
                        limit=limit,
                        max_leaves=max_leaves,
                        start_leaves=resume,
                        k_max=sub_ub,
                    )
                    append_range_results(
                        keys_out, vals_out, counts, idxs, rk, rv, rc, limit
                    )
                    # in-mesh loop: rows come back complete or exhausted;
                    # a truncated row (device round cap) resumes host-side
                    again = trunc & (counts[idxs] < limit)
                    idxs = idxs[again]
                    sub_start = sub_start[again]
                    sub_ub = sub_ub[again]
                    resume = cur_leaf[again]
                    self.range_reissues += int(again.sum())
                self._note_shard_time(
                    s if track else -1, time.perf_counter() - t0
                )
            self._wave_end()
            return RangeResult(keys_out, vals_out, counts)
        # hash partition: broadcast + k-way merge (keys never hit the
        # KEY_MAX sentinel — reserved — so it can pad the sort)
        self.range_subqueries += n * self.n_shards
        per = []
        for s, sh in enumerate(self.shards):
            t0 = time.perf_counter()
            per.append(
                sh.range(start, limit=limit, max_leaves=max_leaves, k_max=k_max)
            )
            self._note_shard_time(s, time.perf_counter() - t0)
        self._wave_end()
        allk = np.concatenate([rk for rk, _, _ in per], axis=1)
        allv = np.concatenate([rv for _, rv, _ in per], axis=1)
        live = np.concatenate(
            [np.arange(limit)[None, :] < rc[:, None] for _, _, rc in per],
            axis=1,
        )
        allk = np.where(live, allk, np.uint64(0xFFFFFFFFFFFFFFFF))
        order = np.argsort(allk, axis=1, kind="stable")[:, :limit]
        top_k = np.take_along_axis(allk, order, axis=1)
        top_v = np.take_along_axis(allv, order, axis=1)
        top_live = np.take_along_axis(live, order, axis=1)
        keys_out[:] = np.where(top_live, top_k, 0)
        vals_out[:] = np.where(top_live, top_v, 0)
        counts[:] = top_live.sum(axis=1)
        return RangeResult(keys_out, vals_out, counts)

    def range_issue(
        self,
        k_min,
        limit: int = 10,
        *,
        k_max=None,
        epoch: Optional[int] = None,
        max_leaves: int = 4,
        fanout: Optional[int] = None,
    ) -> _ShardRangeWave:
        """Issue half of the sharded RANGE: the scatter phase, dispatched
        *speculatively* — the serial path prunes successor sub-queries by
        ``counts < limit``, which needs the predecessors' results; here
        every shard in the fan-out window is issued eagerly so the whole
        scatter overlaps.  Results stay bitwise-equal because the gather
        epilogue clips takes to ``limit - counts`` anyway (a row already
        full appends nothing), and per-row device results are independent
        of which other rows share the sub-batch.  The routing epoch and
        window bounds are captured at issue time — barrier ops drain the
        pipeline before any ownership change.  The accounting
        (``range_subqueries``/``range_reissues``) is updated at gather
        time for rows that actually needed serving, so the counters mean
        the same thing they do on the serial path."""
        start = np.asarray(k_min, dtype=np.uint64)
        n = start.size
        lim = max(limit, 0)
        w = _ShardRangeWave(
            n=n,
            limit=limit,
            max_leaves=max_leaves,
            mode=self.partition,
            empty=(n == 0 or limit <= 0),
            keys_out=np.zeros((n, lim), dtype=np.uint64),
            vals_out=np.zeros((n, lim), dtype=np.uint64),
            counts=np.zeros(n, dtype=np.int64),
            parts=[],
        )
        if w.empty:
            return w
        self.range_requests += n
        if k_max is not None:
            k_max = np.broadcast_to(np.asarray(k_max, dtype=np.uint64), (n,))
        if self.partition == "range":
            with span(self.spans, "kv/shard/route"):
                owner = self.route_np(start, epoch=epoch)
            lb = self.ownership.lower_bounds(epoch)
            ub = self.ownership.upper_bounds(epoch)
            groups = self._groups_for_epoch(epoch)
            track = groups is self.groups
            n_eff = len(groups)
            fanout = n_eff if fanout is None else fanout
            for s in range(n_eff):
                m = (owner <= s) & (s - owner < fanout)
                if not m.any():
                    continue
                idxs = np.where(m)[0]
                sub_start = np.maximum(start[idxs], lb[s])
                sub_ub = np.full(idxs.size, ub[s], dtype=np.uint64)
                if k_max is not None:
                    sub_ub = np.minimum(sub_ub, k_max[idxs])
                serving = self._read_store(s, epoch=epoch)
                sub = serving.range_issue(
                    sub_start, limit=limit, k_max=sub_ub,
                    max_leaves=max_leaves, arity=6,
                )
                w.parts.append(
                    (s if track else -1, idxs, sub_start, sub_ub, serving, sub)
                )
            return w
        self.range_subqueries += n * self.n_shards
        for s, sh in enumerate(self.shards):
            sub = sh.range_issue(
                start, limit=limit, k_max=k_max, max_leaves=max_leaves, arity=3
            )
            w.parts.append((s, None, None, None, sh, sub))
        return w

    def range_finalize(self, w: _ShardRangeWave):
        """Gather half of the sharded RANGE: drain sub-waves in shard
        order, stitching each into the accumulators exactly as the serial
        loop does (including the rare host-resume of device-round-capped
        rows, which runs synchronously on the sub-query's pinned
        replica)."""
        keys_out, vals_out, counts = w.keys_out, w.vals_out, w.counts
        limit = w.limit
        if w.empty:
            return RangeResult(keys_out, vals_out, counts)
        if w.mode == "range":
            for s, idxs_all, sub_start, sub_ub, serving, sub in w.parts:
                t0 = time.perf_counter()
                res = serving.range_finalize(sub)
                # rows already filled by predecessor shards appended
                # nothing on the serial path either — the speculative
                # sub-wave for them is simply discarded
                need = counts[idxs_all] < limit
                idxs = idxs_all[need]
                if idxs.size == 0:
                    self._note_shard_time(s, time.perf_counter() - t0)
                    continue
                self.range_subqueries += int(idxs.size)
                sub_start = sub_start[need]
                sub_ub = sub_ub[need]
                first = (
                    res.keys[need], res.vals[need], res.counts[need],
                    res.truncated[need], res.cursor_leaf[need],
                )
                resume = None
                while idxs.size:
                    if first is not None:
                        rk, rv, rc, trunc, cur_leaf = first
                        first = None
                    else:
                        rk, rv, rc, trunc, cur_leaf, _ = (
                            serving.range_with_state(
                                sub_start,
                                limit=limit,
                                max_leaves=w.max_leaves,
                                start_leaves=resume,
                                k_max=sub_ub,
                            )
                        )
                    append_range_results(
                        keys_out, vals_out, counts, idxs, rk, rv, rc, limit
                    )
                    again = trunc & (counts[idxs] < limit)
                    idxs = idxs[again]
                    sub_start = sub_start[again]
                    sub_ub = sub_ub[again]
                    resume = cur_leaf[again]
                    self.range_reissues += int(again.sum())
                self._note_shard_time(s, time.perf_counter() - t0)
            self._wave_end()
            return RangeResult(keys_out, vals_out, counts)
        # hash tier: drain the broadcast, then the k-way merge epilogue
        per = []
        for s, _, _, _, st, sub in w.parts:
            t0 = time.perf_counter()
            per.append(st.range_finalize(sub))
            self._note_shard_time(s, time.perf_counter() - t0)
        self._wave_end()
        allk = np.concatenate([r.keys for r in per], axis=1)
        allv = np.concatenate([r.vals for r in per], axis=1)
        live = np.concatenate(
            [np.arange(limit)[None, :] < r.counts[:, None] for r in per],
            axis=1,
        )
        allk = np.where(live, allk, np.uint64(0xFFFFFFFFFFFFFFFF))
        order = np.argsort(allk, axis=1, kind="stable")[:, :limit]
        top_k = np.take_along_axis(allk, order, axis=1)
        top_v = np.take_along_axis(allv, order, axis=1)
        top_live = np.take_along_axis(live, order, axis=1)
        keys_out[:] = np.where(top_live, top_k, 0)
        vals_out[:] = np.where(top_live, top_v, 0)
        counts[:] = top_live.sum(axis=1)
        return RangeResult(keys_out, vals_out, counts)

    def _live_stores(self):
        return [st for g in self.groups for st in g if st is not None]

    def flush(self) -> int:
        """One flush cycle per live replica (each a single stitch
        transaction)."""
        return sum(st.flush() for st in self._live_stores())

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        ks, vs = [], []
        clip = self.ownership is not None
        if clip:  # owned-window clip: exact even mid-handoff (a donor's
            # not-yet-retired slice copy sits outside its window)
            lb = self.ownership.lower_bounds()
            ub = self.ownership.upper_bounds()
        for s, sh in enumerate(self.shards):
            k, v = sh.items()
            if clip:
                m = (k >= lb[s]) & (k < ub[s])
                k, v = k[m], v[m]
            ks.append(k)
            vs.append(v)
        order = np.argsort(np.concatenate(ks), kind="stable")
        return np.concatenate(ks)[order], np.concatenate(vs)[order]

    # ------------------------------------------------ point-in-time reads
    def snapshot_epoch(self) -> int:
        """Pin the current stitched state tier-wide and return the facade
        snapshot id ``as_of`` reads name.

        One snapshot = (serving primary store of every group, that store's
        version epoch from ``DPAStore.snapshot_epoch``, the boundary
        vector, the shard count) — all pinned by Python reference, so a
        later rebalance/reshard/failover cannot move data out from under a
        retained read (retired stores stay alive exactly as long as a
        snapshot holds them).  At most ``retain_epochs`` snapshots stay
        live; taking one past the cap evicts the oldest.  A per-STORE
        window can still age out underneath an old facade snapshot (shard
        stores keep flushing), in which case the read raises
        :class:`~repro_torch.core.epoch.EpochRetiredError` — same contract,
        finer clock.

        Refuses mid-handoff: a snapshot must pin exactly one ownership
        generation."""
        if self.retain_epochs <= 0:
            raise EpochRetiredError(
                "snapshot_epoch: facade was built with retain_epochs=0"
            )
        if self.in_handoff or self._retired_groups is not None:
            # NOT an assert: must survive ``python -O``
            raise ValueError(
                "snapshot_epoch during an open handoff: commit (or retire) "
                "the rebalance/reshard/failover epoch first"
            )
        self.flush()
        stores = list(self.shards)  # serving primaries, pinned by reference
        epochs = [st.snapshot_epoch() for st in stores]
        self._snap_seq += 1
        self._snaps[self._snap_seq] = dict(
            stores=stores,
            epochs=epochs,
            boundaries=(
                None if self.ownership is None else self.ownership.current.copy()
            ),
            n_shards=self.n_shards,
        )
        while len(self._snaps) > self.retain_epochs:
            self._snaps.pop(min(self._snaps))
        return self._snap_seq

    def _snap_for(self, as_of: int) -> Dict:

        if self.retain_epochs <= 0:
            raise EpochRetiredError(
                f"as_of={as_of}: facade was built with retain_epochs=0 "
                "(no point-in-time window is kept)"
            )
        snap = self._snaps.get(int(as_of))
        if snap is None:
            raise EpochRetiredError(
                f"as_of={as_of}: facade snapshot unknown or evicted "
                f"(live snapshots: {sorted(self._snaps)})"
            )
        return snap

    def _get_as_of(self, keys: np.ndarray, as_of: int):
        """Versioned GET: route by the PINNED boundary vector (or the
        pinned shard count, hash tier) to the PINNED stores, each serving
        its rows at its pinned version epoch."""
        snap = self._snap_for(as_of)
        if snap["boundaries"] is not None:
            dest = np.searchsorted(
                snap["boundaries"], keys, side="right"
            ).astype(np.int32)
        else:
            dest = shard_of_np(keys, snap["n_shards"])
        vals = np.zeros(keys.size, dtype=np.uint64)
        found = np.zeros(keys.size, dtype=bool)
        for s, (st, e) in enumerate(zip(snap["stores"], snap["epochs"])):
            m = dest == s
            if m.any():
                v, f = st.get(keys[m], as_of=e)
                vals[m] = v
                found[m] = f
        return vals, found

    def _range_as_of(
        self, k_min, limit: int, *, k_max, max_leaves, fanout, as_of: int
    ):
        """Versioned scatter-gather RANGE over a pinned snapshot: owner +
        successor sub-queries clipped to the pinned owned windows, each a
        per-store ``as_of`` walk (which runs its in-mesh loop unbounded, so
        sub-queries come back complete except at the chain hard cap — the
        rare host resume re-descends from the last emitted key + 1)."""
        snap = self._snap_for(as_of)
        start = np.asarray(k_min, dtype=np.uint64)
        n = start.size
        lim = max(limit, 0)
        keys_out = np.zeros((n, lim), dtype=np.uint64)
        vals_out = np.zeros((n, lim), dtype=np.uint64)
        counts = np.zeros(n, dtype=np.int64)
        stats = {"as_of": int(as_of)}
        if n == 0 or limit <= 0:
            return RangeResult(keys_out, vals_out, counts, stats=stats)
        self.range_requests += n
        if k_max is not None:
            k_max = np.broadcast_to(np.asarray(k_max, dtype=np.uint64), (n,))
        stores, epochs_v = snap["stores"], snap["epochs"]
        n_snap = snap["n_shards"]
        if snap["boundaries"] is None:
            # hash snapshot: broadcast + the same k-way merge the live
            # hash tier runs, each sub-query versioned
            self.range_subqueries += n * n_snap
            per = [
                st.range(
                    start, limit=limit, k_max=k_max,
                    max_leaves=max_leaves, as_of=e,
                )
                for st, e in zip(stores, epochs_v)
            ]
            allk = np.concatenate([r.keys for r in per], axis=1)
            allv = np.concatenate([r.vals for r in per], axis=1)
            live = np.concatenate(
                [np.arange(limit)[None, :] < r.counts[:, None] for r in per],
                axis=1,
            )
            allk = np.where(live, allk, np.uint64(KEY_MAX))
            order = np.argsort(allk, axis=1, kind="stable")[:, :limit]
            top_k = np.take_along_axis(allk, order, axis=1)
            top_v = np.take_along_axis(allv, order, axis=1)
            top_live = np.take_along_axis(live, order, axis=1)
            keys_out[:] = np.where(top_live, top_k, 0)
            vals_out[:] = np.where(top_live, top_v, 0)
            counts[:] = top_live.sum(axis=1)
            return RangeResult(keys_out, vals_out, counts, stats=stats)
        b = snap["boundaries"]
        owner = np.searchsorted(b, start, side="right").astype(np.int32)
        lb = np.concatenate([np.zeros(1, dtype=np.uint64), b])
        ub = np.concatenate([b, np.full(1, KEY_MAX, dtype=np.uint64)])
        fanout = n_snap if fanout is None else fanout
        for s in range(n_snap):
            m = (owner <= s) & (s - owner < fanout) & (counts < limit)
            if not m.any():
                continue
            idxs = np.where(m)[0]
            self.range_subqueries += int(idxs.size)
            sub_start = np.maximum(start[idxs], lb[s])
            sub_ub = np.full(idxs.size, ub[s], dtype=np.uint64)
            if k_max is not None:
                sub_ub = np.minimum(sub_ub, k_max[idxs])
            while idxs.size:
                res = stores[s].range(
                    sub_start, limit=limit, k_max=sub_ub,
                    max_leaves=max_leaves, as_of=epochs_v[s],
                )
                append_range_results(
                    keys_out, vals_out, counts, idxs,
                    res.keys, res.vals, res.counts, limit,
                )
                trunc = (
                    np.asarray(res.truncated, dtype=bool)
                    if res.truncated is not None
                    else np.zeros(idxs.size, dtype=bool)
                )
                again = trunc & (counts[idxs] < limit)
                if not again.any():
                    break
                # resume past the last emitted key (fresh versioned descent;
                # keys never reach the KEY_MAX sentinel, so +1 cannot wrap)
                nxt = res.cursor_key[again].astype(np.uint64) + np.uint64(1)
                still = nxt < sub_ub[again]
                idxs = idxs[again][still]
                sub_start = nxt[still]
                sub_ub = sub_ub[again][still]
                self.range_reissues += int(idxs.size)
        return RangeResult(keys_out, vals_out, counts, stats=stats)

    # ------------------------------------------------- TTL & compaction
    def stub_count(self) -> int:
        """Empty routing-stub leaves across every live replica."""
        return sum(st.stub_count() for st in self._live_stores())

    def compact_chain(self) -> int:
        """One chain-compaction stitch per live replica; returns the
        number of stubs removed tier-wide."""
        return sum(st.compact_chain() for st in self._live_stores())

    def ttl_sweep(self) -> int:
        """Physically reclaim expired keys tier-wide: ROUTED tombstones
        (delete -> flush -> chain compaction).  Facade-level on purpose —
        a per-shard ``ttl_sweep`` against the SHARED tracker would stage
        tombstones for every shard's expired keys on every shard.  Returns
        the number of keys reclaimed."""
        expired = self.ttl.expired_keys()
        if not expired:
            return 0
        keys = np.array(sorted(expired), dtype=np.uint64)
        self.delete(keys)  # routed fan-out; note_delete prunes the tracker
        self.flush()
        self.compact_chain()
        return int(keys.size)

    def maybe_compact(self) -> Optional[Dict[str, int]]:
        """Planner-gated reclamation sweep: TTL tombstones + chain
        compaction once the reclaimable backlog (expired keys + empty leaf
        stubs) crosses ``RebalanceConfig.compact_stub_trigger``.  The serve
        loop calls this once per wave batch next to ``maybe_rebalance``;
        it is cheap when there is nothing to reclaim."""
        if self.planner is None or self.in_handoff:
            return None
        n_expired = len(self.ttl.expired_keys())
        stubs = self.stub_count()
        if not self.planner.should_compact(stubs + n_expired):
            return None
        reclaimed = self.ttl_sweep()  # compacts once itself when it fires
        compacted = self.compact_chain()  # stub-only trigger path
        return {
            "ttl_reclaimed": reclaimed,
            "stubs_compacted": compacted,
            "backlog": stubs + n_expired,
        }

    def stacked(self, epoch: Optional[int] = None) -> Tuple[DeviceTree, InsertBuffers, int]:
        """Stack the serving replica of each group for the device wave
        paths.  ``epoch`` selects the primary map of a live ownership epoch
        (during a failover drain both are stackable; boundaries are
        identical so either epoch's wave reads the same data)."""
        if self.ownership is None:
            return stack_shards(self.shards)
        from .rangeshard import replica_serving_stores

        assert self._groups_for_epoch(epoch) is self.groups, (
            "cannot stack the retired reshard generation: its shard count "
            "differs from the current mesh — drain old-epoch waves through "
            "the host facade and commit_reshard first"
        )
        return stack_shards(
            replica_serving_stores(self.groups, self.ownership.primary_for(epoch))
        )

    # ------------------------------------------------- replication (range)
    def kill_replica(self, group: int, replica: Optional[int] = None) -> Optional[int]:
        """Fault injection: crash replica ``replica`` of shard ``group``
        (default: its current primary).  Killing a follower just shrinks
        the in-sync set; killing the primary installs a *failover epoch* —
        ``OwnershipTable.install(new_primary=...)`` with the boundary
        vector unchanged — promoting the lowest in-sync survivor.  Returns
        the promoted replica index (None for a follower death).  In-flight
        waves admitted under the old epoch keep routing by it; call
        :meth:`retire_failover` once they drain.  Refuses to run mid
        rebalance-handoff (the two-epoch window is single-occupancy —
        drain and commit first)."""
        assert self.ownership is not None, "replication is a range-tier feature"
        assert self.replication > 1, "killing the only replica loses the slice"
        if replica is None:
            replica = int(self.ownership.primary[group])
        promoted = self.ownership.fail_replica(group, replica)
        self.groups[group][replica] = None
        if promoted is not None:
            self.failovers += 1
        return promoted

    def retire_failover(self) -> None:
        """Drop the pre-failover epoch once its in-flight waves drained
        (the failover analogue of :meth:`commit_rebalance`'s epoch
        retirement — there are no stale slice copies to tombstone because
        the boundaries never moved)."""
        assert self.ownership is not None and self.ownership.in_handoff
        assert self._retired_groups is None, (
            "the open handoff is a reshard: commit_reshard retires it"
        )
        self.ownership.retire_previous()

    def recover_replicas(self):
        """Re-replicate every crashed slot from its group's primary (or
        lowest in-sync survivor): ``elastic.plan_replica_remesh`` picks the
        sources, then each rebuild is one full ``snapshot_slice`` fed
        through ``ingest_slice`` into a fresh empty store — the same
        batched patch/stitch pipeline the rebalance copy phase uses — or a
        direct bulk load when the snapshot exceeds a fresh store's ingest
        headroom.  Rebuilt replicas re-enter the in-sync set (reads and
        write fan-out include them again).  Returns the executed plan."""
        assert self.ownership is not None, "replication is a range-tier feature"
        alive = [
            [self.groups[s][r] is not None for r in range(self.replication)]
            for s in range(self.n_shards)
        ]
        plan = plan_replica_remesh(
            self.n_shards,
            self.replication,
            alive,
            primaries=[int(p) for p in self.ownership.primary],
        )
        for rb in plan.rebuilds:
            k, v = self.groups[rb.group][rb.source].snapshot_slice(0, KEY_MAX)
            self.groups[rb.group][rb.replica] = self._fresh_store_with(k, v)
            self.ownership.restore_replica(rb.group, rb.replica)
            self.recoveries += 1
        return plan

    # --------------------------------------------- online rebalance (range)
    def shard_occupancy(self, flush: bool = False) -> np.ndarray:
        """Live stitched keys per shard.  ``flush=True`` drains staged
        writes first for an exact census (the planner's trigger probe and
        the benchmarks do; a slightly stale count is fine for routing)."""
        if flush:
            self.flush()
        return np.array([sh.live_count() for sh in self.shards], dtype=np.int64)

    def occupancy_spread(self, flush: bool = False) -> Dict[str, float]:
        """Occupancy balance report: max/mean ``ratio`` is the planner's
        trigger quantity (1.0 = perfectly balanced)."""
        occ = self.shard_occupancy(flush=flush)
        return {
            "min": int(occ.min()),
            "max": int(occ.max()),
            "mean": float(occ.mean()),
            "ratio": RebalancePlanner.spread(occ),
        }

    def begin_rebalance(self, new_boundaries=None) -> List:
        """Phase 1 of an online rebalance: copy every moving slice into its
        receiver, then install ``new_boundaries`` as the current boundary
        epoch while the old vector stays live (the *handoff* epoch).

        From this call on, fresh requests route by the new vector — the
        receivers own (and hold) the migrated slices; waves admitted
        earlier keep routing by the epoch they carry
        (``route_np(keys, epoch=...)``).  Donors still hold their stale
        copies, made invisible to RANGE by the owned-window clip; call
        :meth:`commit_rebalance` once the old epoch's waves have drained.

        ``new_boundaries=None`` asks the planner for a refit.  A receiver
        without enough ingest headroom for the sum of its incoming slices
        aborts the whole rebalance (the boundary vector is untouched;
        ``rebalances_aborted`` counts it) — pool pressure must degrade to
        the status quo, never to a half-moved partition map.  Returns the
        executed slice moves; an empty list means nothing happened and no
        handoff was opened (no-op proposal, or headroom abort — told apart
        by ``rebalances_aborted``).
        """
        assert self.partition == "range", "rebalancing is a range-tier op"
        assert not self.in_handoff, "commit the previous rebalance first"
        if new_boundaries is None:
            assert self.planner is not None, "no planner: pass boundaries"
            new_boundaries = self.planner.propose(self.ownership.current)
        new_boundaries = np.asarray(new_boundaries, dtype=np.uint64)
        moves = [
            mv
            for mv in plan_moves(self.ownership.current, new_boundaries)
            if mv.width > 0
        ]
        if not moves:  # no-op proposal: nothing to hand off, no epoch flip
            return []
        # headroom precheck before any copy lands.  A cascaded move's slice
        # can span two donors pre-copy (it hops through the intermediate
        # shard), so count each slice across ALL shards — exact for the
        # pre-move state, and every holder is itself a donor, so flushing
        # the donors makes the stitched counts the whole truth.  Headroom
        # is checked CUMULATIVELY per receiver: a refit can grow one shard
        # from both sides, and each slice fitting alone does not mean both
        # fit together.
        for s in {mv.donor for mv in moves}:
            for r in self._in_sync(s):  # replicas flush in lockstep so the
                self.groups[s][r].flush()  # stitched counts stay the truth
        need: Dict[int, int] = {}
        for mv in moves:
            n = sum(sh.count_slice(mv.k_lo, mv.k_hi) for sh in self.shards)
            need[mv.receiver] = need.get(mv.receiver, 0) + n
        for receiver, n in need.items():
            # every in-sync receiver replica ingests the same slices, so
            # the scarcest replica's headroom gates the whole group
            headroom = min(
                self.groups[receiver][r].ingest_headroom()
                for r in self._in_sync(receiver)
            )
            if n > headroom:
                self.rebalances_aborted += 1
                return []
        for mv in moves:  # copy phase (donors keep serving their slices)
            k, v = self.shards[mv.donor].snapshot_slice(mv.k_lo, mv.k_hi)
            for r in self._in_sync(mv.receiver):
                self.groups[mv.receiver][r].ingest_slice(k, v)
        self.ownership.install(new_boundaries)
        self._pending_moves = moves
        return moves

    def commit_rebalance(self) -> int:
        """Phase 2: retire the donors' stale slice copies (a leaf run of
        tombstones through the patch/stitch pipeline — which also drops the
        donors' scan anchors over the migrated leaves via the epoch
        manager's ``on_defer`` listener) and drop the old boundary vector.
        Call after the handoff epoch's in-flight waves have drained.
        Returns the number of keys migrated."""
        assert self.in_handoff, "begin_rebalance first"
        assert self._retired_groups is None, (
            "the open handoff is a reshard: commit_reshard retires it"
        )
        migrated = 0
        for mv in self._pending_moves:
            primary = int(self.ownership.primary[mv.donor]) if self.ownership else 0
            for r in self._in_sync(mv.donor):
                k, _ = self.groups[mv.donor][r].extract_slice(mv.k_lo, mv.k_hi)
                if r == primary:  # replicas are identical: count one copy
                    migrated += int(k.size)
        # chain compaction: extract_slice leaves one empty routing stub per
        # emptied leaf; without this pass they accumulate cycle over cycle
        # (ingest re-creates leaves at split_cap fill, so an oscillating
        # storm ratchets the stub count until the pools exhaust)
        for s in {mv.donor for mv in self._pending_moves}:
            for r in self._in_sync(s):
                self.groups[s][r].compact_chain()
        self.ownership.retire_previous()
        self._pending_moves = []
        self.rebalances += 1
        self.migrated_keys += migrated
        return migrated

    def rebalance(self, new_boundaries=None) -> Dict[str, float]:
        """One synchronous rebalance cycle (begin + commit back-to-back —
        sound here because the host facade serializes waves; the split API
        exists for callers, and tests, that interleave).  Returns a summary
        including the post-rebalance occupancy spread."""
        moves = self.begin_rebalance(new_boundaries)
        migrated = self.commit_rebalance() if self.in_handoff else 0
        report = self.occupancy_spread()
        report["moves"] = len(moves)
        report["migrated_keys"] = migrated
        return report

    def maybe_rebalance(self) -> Optional[Dict[str, float]]:
        """Planner-gated rebalance: refit + migrate only when the occupancy
        spread crosses the trigger.  The serve loop (and fig18) calls this
        once per wave batch; it is cheap when the tier is balanced."""
        if self.planner is None or self.partition != "range":
            return None
        if self.in_handoff:  # two-epoch window is single-occupancy
            return None
        if not self.planner.should_rebalance(self.shard_occupancy(flush=True)):
            return None
        return self.rebalance()

    # ------------------------------------------------ elastic reshard (range)
    def begin_reshard(
        self, new_shards: int, new_boundaries=None
    ) -> Optional[np.ndarray]:
        """Phase 1 of a live reshard: grow or shrink the shard count in
        place while GET/PUT/RANGE keep serving.

        The donor fleet is snapshotted as ONE epoch-consistent ordered run
        (``flush`` + owned-window :meth:`items` — exactly the cut
        ``distributed.snapshot`` persists), quantile boundaries are fitted
        for the NEW width (planner reservoir sample when armed, census
        keys otherwise), and every new shard group is built complete —
        ``ingest_slice`` of its slice into ``replication`` fresh stores
        (bulk load when a slice exceeds a fresh store's ingest headroom,
        the ``recover_replicas`` discipline) — BEFORE the ownership flip.
        The flip itself is the same two-phase ``OwnershipTable.install``
        a rebalance rides, except the boundary vector changes LENGTH: the
        old generation of groups is retained wholesale (``_retired_groups``)
        so waves admitted under the old epoch keep routing over the old
        fleet width, and fresh requests route over the new one.  Writes
        admitted during the handoff go to the new generation only — the
        retired generation is a read-only snapshot of the pre-flip state,
        which is exactly what old-epoch readers are entitled to see (the
        same staleness contract a rebalance donor's retained copy has).

        Call :meth:`commit_reshard` once old-epoch waves have drained.
        Returns the installed boundary vector, or ``None`` for a no-op
        (``new_shards`` equals the current count and no explicit
        boundaries were given).  A reshard also heals crashed replica
        slots as a side effect: every new group starts fully in-sync."""
        assert self.partition == "range", "resharding is a range-tier op"
        assert not self.in_handoff, "commit the open handoff first"
        assert new_shards >= 1, f"new_shards must be positive, got {new_shards}"
        if new_shards == self.n_shards and new_boundaries is None:
            return None
        self.flush()  # exact census: staged writes become stitched truth
        keys, vals = self.items()  # the epoch-consistent global ordered run
        if new_boundaries is None:
            sample = (
                self.planner.sample.snapshot()
                if self.planner is not None
                else np.empty(0, dtype=np.uint64)
            )
            new_boundaries = pla.fit_boundaries(
                sample if sample.size else keys, new_shards
            )
        new_boundaries = np.asarray(new_boundaries, dtype=np.uint64)
        assert new_boundaries.size == new_shards - 1, (
            f"{new_shards} shards need {new_shards - 1} boundaries, "
            f"got {new_boundaries.size}"
        )
        cuts = np.concatenate(
            [
                np.zeros(1, dtype=np.int64),
                np.searchsorted(keys, new_boundaries, side="left"),
                np.full(1, keys.size, dtype=np.int64),
            ]
        )
        new_groups: List[List[Optional[DPAStore]]] = []
        for s in range(new_shards):
            k = keys[cuts[s] : cuts[s + 1]]
            v = vals[cuts[s] : cuts[s + 1]]
            new_groups.append(
                [self._fresh_store_with(k, v) for _ in range(self.replication)]
            )
        self._retired_groups = self.groups
        self.groups = new_groups
        self.n_shards = new_shards
        self.ownership.install(new_boundaries)  # size-changing epoch flip
        self._reshard_keys_pending = int(keys.size)
        # the fleet planner is per-width state: rebuild it for the new
        # mesh, reseeded with the full census (a strictly better sample
        # than the reservoir it replaces)
        if self.planner is not None:
            self.planner = RebalancePlanner(self.planner.cfg, new_shards)
            self.planner.observe(keys)
        # straggler state is keyed by shard id — a reshard reassigns hosts
        self.shard_drain_ns = np.zeros(new_shards, dtype=np.int64)
        if self.watchdog is not None:
            self.watchdog.times.clear()
            self.watchdog.strikes.clear()
            self.watchdog.flagged.clear()
        return new_boundaries

    def commit_reshard(self) -> int:
        """Phase 2: retire the pre-flip generation wholesale (whole donor
        stores are dropped — no tombstone runs, unlike a rebalance donor
        that keeps its store) and drop the old boundary vector.  Call
        after the old epoch's in-flight waves have drained.  Returns the
        number of keys resharded."""
        assert self._retired_groups is not None, "begin_reshard first"
        self._retired_groups = None
        self.ownership.retire_previous()
        moved = int(self._reshard_keys_pending)
        self._reshard_keys_pending = 0
        self.reshards += 1
        self.resharded_keys += moved
        return moved

    def reshard(self, new_shards: int, new_boundaries=None) -> Dict[str, float]:
        """One synchronous reshard cycle (begin + commit back-to-back —
        sound here because the host facade serializes waves; the split API
        exists for callers, and tests, that interleave old-epoch traffic
        with the handoff).  Returns a summary including the post-reshard
        occupancy spread."""
        installed = self.begin_reshard(new_shards, new_boundaries)
        moved = self.commit_reshard() if installed is not None else 0
        report = self.occupancy_spread()
        report["n_shards"] = self.n_shards
        report["resharded_keys"] = moved
        return report

    # --------------------------------------------- straggler evacuation
    def evacuate_shard(self, s: int) -> int:
        """Evacuate shard group ``s`` to fresh hosts: every in-sync
        replica is rebuilt from its own epoch-consistent snapshot
        (``flush`` + ``snapshot_slice`` + ``ingest_slice`` into a fresh
        store — bulk load past headroom), emulating a migration off a
        persistently slow host.  No epoch flip: the boundary vector is
        untouched and the rebuilt replica is bitwise content-equal, so
        routing never observes the move.  Returns keys moved."""
        assert not self.in_handoff, (
            "evacuation during a handoff would snapshot stale out-of-window"
            " copies — commit first"
        )
        moved = 0
        for r in self._in_sync(s):
            st = self.groups[s][r]
            if st is None:
                continue
            st.flush()
            k, v = st.snapshot_slice(0, KEY_MAX)
            self.groups[s][r] = self._fresh_store_with(k, v)
            moved = int(k.size)  # replicas are identical: count one copy
        self.evacuations += 1
        if self.watchdog is not None:
            # the replacement host starts with a clean bill of health
            self.watchdog.times.pop(s, None)
            self.watchdog.strikes.pop(s, None)
            self.watchdog.flagged.pop(s, None)
        return moved

    def maybe_evacuate(self) -> Optional[Dict]:
        """Watchdog-gated evacuation: when the straggler plan names shards
        persistently slower than the fleet median (EWMA of real per-shard
        wave drain times, ``patience`` consecutive strikes), evacuate each
        to fresh hosts.  The serve loop calls this once per wave batch;
        it is free when the watchdog is unarmed or the fleet healthy."""
        if self.watchdog is None or self.in_handoff:
            return None
        plan = self.watchdog.plan(self.n_shards)
        if plan.get("action") != "remesh":
            return None
        evacuated = [s for s in plan["drop_hosts"] if 0 <= s < self.n_shards]
        moved = sum(self.evacuate_shard(s) for s in evacuated)
        return {"evacuated": evacuated, "moved_keys": moved, "plan": plan}

    @property
    def range_rounds_in_mesh(self) -> int:
        """Continuation rounds the shards ran inside their device loops
        (rounds after the first of each dispatch) — the round-trips the
        in-mesh loop keeps off the host, vs ``range_reissues`` which counts
        the host round-trips that survived."""
        return sum(st.stats.range_rounds_in_mesh for st in self._live_stores())

    @property
    def write_amplification(self) -> float:
        """Replica writes per client write (R when every replica is
        in-sync; drops toward 1 while replicas are down — fig19's
        write-cost axis)."""
        return self.replica_writes / max(self.client_writes, 1)

    def stats_totals(self) -> Dict[str, int]:
        """Aggregate StoreStats across live replicas (flush cycle / stitch
        apply accounting for the benchmarks)."""
        out: Dict[str, int] = {}
        for st in self._live_stores():
            for k, v in vars(st.stats).items():
                if isinstance(v, (int, np.integer)):
                    out[k] = out.get(k, 0) + int(v)
        return out

def _drop_scatter(n: int, fill, dtype, idx, src, tail=()):
    """``zeros((n, *tail)).at[idx].set(src, mode="drop")``: indices at or
    past ``n`` land in one scratch row that is sliced away."""
    out = torch.full((n + 1, *tail), fill, dtype=dtype, device=idx.device)
    out[torch.clamp(idx, max=n)] = src.to(dtype)
    return out[:n]


def _bucketize(dest, khi, klo, n_shards: int, cap: int, extra=()):
    """Group a shard's local requests by destination shard into fixed
    (n_shards, cap) buckets.  Returns (bk_hi, bk_lo, origin_idx, valid)
    plus one bucketed tensor per ``extra`` payload (same scatter, zero
    fill) — the range tier ships per-request epoch tags this way.

    ``dest`` is the per-request destination shard; values outside
    ``[0, n_shards)`` act as a drop sentinel (the request lands in no
    bucket and its origin slot stays -1) — the range tier uses this for
    fan-out replicas that run past the last shard.  A request past its
    bucket's ``cap`` lands in no bucket either (RETRY at the caller)."""
    W = khi.shape[0]
    dev = khi.device
    order = torch.sort(dest, stable=True).indices
    dest_s = dest[order].to(torch.int64)
    pos = torch.arange(W, dtype=torch.int64, device=dev)
    first = torch.ones(W, dtype=torch.bool, device=dev)
    first[1:] = dest_s[1:] != dest_s[:-1]
    group_start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    rank = pos - group_start
    ok = rank < cap
    n = n_shards * cap
    slot = torch.where(ok, dest_s * cap + rank, n)  # sentinel dest: past the end too
    bk_hi = _drop_scatter(n, 0, torch.int32, slot, khi[order])
    bk_lo = _drop_scatter(n, 0, torch.int32, slot, klo[order])
    origin = _drop_scatter(n, -1, torch.int32, slot, order)
    # NB: ``ok`` lives in the sorted domain like ``slot`` — indexing it by
    # ``order`` would mix domains and mark landed requests as dropped
    valid = _drop_scatter(n, False, torch.bool, slot, ok)
    outs = (
        bk_hi.reshape(n_shards, cap),
        bk_lo.reshape(n_shards, cap),
        origin.reshape(n_shards, cap),
        valid.reshape(n_shards, cap),
    )
    bextra = tuple(_drop_scatter(n, 0, a.dtype, slot, a[order]).reshape(n_shards, cap) for a in extra)
    return outs + bextra if bextra else outs


def _local_get(tree, ib, khi, klo, *, depth, eps_inner, eps_leaf):
    """One shard's GET on kernel B1."""
    return ops.get(tree, ib, khi.contiguous(), klo.contiguous(), depth=depth, eps_inner=eps_inner, eps_leaf=eps_leaf)


def _scatter_back(origin, valid, vh, vl, fd, W: int):
    """Responses of one source shard's buckets back to request order."""
    idx = torch.where(origin.reshape(-1) >= 0, origin.reshape(-1).to(torch.int64), W)
    return (
        _drop_scatter(W, 0, torch.int32, idx, vh.reshape(-1)),
        _drop_scatter(W, 0, torch.int32, idx, vl.reshape(-1)),
        _drop_scatter(W, False, torch.bool, idx, fd.reshape(-1)),
        _drop_scatter(W, False, torch.bool, idx, valid.reshape(-1)),
    )


def make_serve_wave(
    n_shards: int,
    cap: int,
    *,
    depth: int,
    eps_inner: int,
    eps_leaf: int,
    route_fn=None,
    route_fn_prev=None,
):
    """Builds the per-shard wave body.

    Inputs per shard: local request tile (W,) + the shard's store state.
    The all-to-all exchange is a callable (row ``d`` of a ``(n_shards,
    ...)`` tensor goes to shard ``d``), so a multi-device path can pass a
    collective.  ``route_fn(khi, klo) -> dest`` defaults to the hash
    partition; the range tier passes a boundary search instead.

    ``route_fn_prev`` supports a mixed in-flight wave during a two-phase
    ownership handoff: the body then takes a per-request ``tag`` ((W,) i32;
    0 = previous epoch, 1 = current) and routes each request by exactly the
    vector of the epoch it was admitted under.  The tag rides the exchange
    next to the key limbs; GET *serving* is epoch-invariant (during a
    handoff the donor still physically holds its migrated slice), so no
    per-epoch window clip is needed on the serving side.
    """
    if route_fn is None:
        route_fn = partial(shard_of, n_shards=n_shards)

    def body(tree, ib, khi, klo, all_to_all, tag=None):
        dest = route_fn(khi, klo)
        if route_fn_prev is not None:
            t = (
                torch.as_tensor(tag, dtype=torch.int32, device=khi.device)
                if tag is not None
                else torch.ones(khi.shape, dtype=torch.int32, device=khi.device)
            )
            dest = torch.where(t > 0, dest, route_fn_prev(khi, klo))
            bk_hi, bk_lo, origin, valid, bk_tag = _bucketize(dest, khi, klo, n_shards, cap, extra=(t,))
            _ = all_to_all(bk_tag)  # admitted-epoch tag on the wire (audit)
        else:
            bk_hi, bk_lo, origin, valid = _bucketize(dest, khi, klo, n_shards, cap)
        # exchange: row d of my buckets goes to shard d
        rq_hi = all_to_all(bk_hi)  # (n_shards, cap) requests I now own
        rq_lo = all_to_all(bk_lo)
        vhi, vlo, found = _local_get(
            tree, ib, rq_hi.reshape(-1), rq_lo.reshape(-1),
            depth=depth, eps_inner=eps_inner, eps_leaf=eps_leaf,
        )
        # route responses back
        rs_vhi = all_to_all(vhi.reshape(n_shards, cap))
        rs_vlo = all_to_all(vlo.reshape(n_shards, cap))
        rs_fnd = all_to_all(found.reshape(n_shards, cap).to(torch.int32))
        return _scatter_back(origin, valid, rs_vhi, rs_vlo, rs_fnd, khi.shape[0])

    return body


def serve_wave_emulated(
    stacked_tree: DeviceTree,
    stacked_ib: InsertBuffers,
    khi: torch.Tensor,  # (n_shards, W)
    klo: torch.Tensor,
    *,
    cap: int,
    depth: int,
    eps_inner: int,
    eps_leaf: int,
    route_fn=None,
    route_fn_prev=None,
    epoch_tag=None,
):
    """Single-device emulation: a loop over the shard dim; the exchange is a
    transpose of the (shard, dest, cap) bucket tensor, and each destination
    shard serves its requests with kernel B1 on its slice of the stacked
    pools.  Returns (vhi, vlo, found, ok), each (n_shards, W); ``ok`` False
    marks a request its bucket's ``cap`` dropped (RETRY).

    ``route_fn_prev`` + ``epoch_tag`` ((n_shards, W) i32; 0 = previous
    epoch, 1 = current) route a mixed in-flight handoff wave per request —
    see :func:`make_serve_wave`."""
    n_shards, W = khi.shape
    if route_fn is None:
        route_fn = partial(shard_of, n_shards=n_shards)
    if route_fn_prev is not None:
        tag = (
            torch.as_tensor(epoch_tag, dtype=torch.int32, device=khi.device)
            if epoch_tag is not None
            else torch.ones(khi.shape, dtype=torch.int32, device=khi.device)
        )
        bk = []
        for s in range(n_shards):
            h, l, t = khi[s], klo[s], tag[s]
            dest = torch.where(t > 0, route_fn(h, l), route_fn_prev(h, l))
            bk.append(_bucketize(dest, h, l, n_shards, cap, extra=(t,))[:4])
    else:
        bk = [_bucketize(route_fn(khi[s], klo[s]), khi[s], klo[s], n_shards, cap) for s in range(n_shards)]
    bk_hi, bk_lo, origin, valid = (torch.stack(x) for x in zip(*bk))
    rq_hi = bk_hi.transpose(0, 1)  # (dest, src, cap)
    rq_lo = bk_lo.transpose(0, 1)
    served = []
    for d in range(n_shards):
        tree, ib = shard_state(stacked_tree, stacked_ib, d)
        served.append(
            _local_get(
                tree, ib, rq_hi[d].reshape(-1), rq_lo[d].reshape(-1),
                depth=depth, eps_inner=eps_inner, eps_leaf=eps_leaf,
            )
        )
    vhi, vlo, found = (torch.stack(x) for x in zip(*served))
    # responses back: (dest, src, cap) -> (src, dest, cap)
    rs_vhi = vhi.reshape(n_shards, n_shards, cap).transpose(0, 1)
    rs_vlo = vlo.reshape(n_shards, n_shards, cap).transpose(0, 1)
    rs_fnd = found.reshape(n_shards, n_shards, cap).transpose(0, 1)
    outs = [_scatter_back(origin[s], valid[s], rs_vhi[s], rs_vlo[s], rs_fnd[s], W) for s in range(n_shards)]
    return tuple(torch.stack(x) for x in zip(*outs))


class MeshExchange:
    """One rank's all-to-all over a process group: row ``d`` of a ``(n,
    ...)`` tensor goes to rank ``d`` of the group, row ``s`` of the result
    came from rank ``s`` (the reference's ``jax.lax.all_to_all(x[None],
    "data", split_axis=1, concat_axis=0)``).  Counts its calls, the bytes
    it hands over (the whole tensor, the row a rank keeps included) and its
    host seconds; on the card it synchronises before and after, so the
    seconds hold the collective alone, staging copies included."""

    def __init__(self, group):
        self.group = group
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = torch.empty_like(x)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        dist.all_to_all_single(out, x, group=self.group)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.bytes += x.numel() * x.element_size()
        return out


def _check_stack(stacked_tree, n_shards: int) -> None:
    if stacked_tree.root.shape[0] != n_shards:
        raise ValueError(f"a stack of {stacked_tree.root.shape[0]} shards on a mesh whose data axis has {n_shards}")


def serve_wave_sharded(
    mesh, stacked_tree, stacked_ib, *, cap, depth, eps_inner, eps_leaf, route_fn=None, route_fn_prev=None,
):
    """The GET wave over the mesh's ``data`` axis: every rank runs
    :func:`make_serve_wave`'s body on its own shard, the exchange a
    :class:`MeshExchange` over the axis's process group, so B1 runs once
    per rank per wave.

    Returns ``fn(tree, ib, khi, klo)`` — or, with ``route_fn_prev`` (a live
    ownership handoff), ``fn(tree, ib, khi, klo, epoch_tag)`` — for each
    rank to call with its shard's pools (``shard_state(stacked_tree,
    stacked_ib, rank)``) and its ``(1, W)`` request rows (``epoch_tag``
    likewise); it gives back that rank's ``(1, W)`` rows of ``(vhi, vlo,
    found, ok)``, the per-shard block of ``serve_wave_emulated``'s
    outputs.  Every rank must call it with the same ``W``.  ``fn.exchange``
    holds the exchange's counters."""
    group, n_shards, _ = data_axis(mesh)
    _check_stack(stacked_tree, n_shards)
    body = make_serve_wave(
        n_shards, cap, depth=depth, eps_inner=eps_inner, eps_leaf=eps_leaf,
        route_fn=route_fn, route_fn_prev=route_fn_prev,
    )
    a2a = MeshExchange(group)

    def fn(tree, ib, khi, klo, epoch_tag=None):
        if (epoch_tag is None) != (route_fn_prev is None):
            raise TypeError("epoch_tag goes with route_fn_prev, and only with it")
        # with route_fn_prev every rank sends the tag exchange, so the ranks
        # issue the same sequence of collectives
        out = body(tree, ib, khi[0], klo[0], a2a, tag=None if epoch_tag is None else epoch_tag[0])
        return tuple(o[None] for o in out)

    fn.exchange = a2a
    return fn
