"""DPA-Store facade: the single-shard KV store — the PyTorch port of the JAX
package's ``core/store.py``.

The public surface is the paper's stateless-client protocol: batched GET /
INSERT / UPDATE / DELETE / RANGE over u64 keys and u64 values.  One call =
one *request wave*.  Internals:

  GET wave   -> steering hash -> hot cache probe (kernel B2, P=2)
             -> descent + insert buffer + leaf probe (kernel B1) -> responses
  RANGE wave -> scan-anchor probe (kernel B2, P=1; descent skip on hit)
             -> bounded leaf walk (kernel B3) + buffer merge, resumed from
                its cursor until limit / exhaustion
  PUT/DELETE -> descent -> per-leaf insert buffers; full buffers -> host
                patcher -> stitch batch -> COPY, CONNECT -> epoch advance
                (+ scan-anchor invalidation) -> quarantined ids reclaimed
  as_of=E    -> live descent -> leaf resolved to its epoch-E version through
                a host-built resolve table -> that version's rows (plain
                torch: the reference runs this path outside any kernel too)

Unlike the JAX store, which calls the jnp functions directly, this store
dispatches GET, both cache probes and the RANGE walk through
``repro_torch.kernels.ops``: on CUDA tensors the hand-written kernels run,
on CPU tensors their plain versions.  The state lives on ``device``, which
defaults to the card; the CPU is used only when asked for.  Insert buffers,
caches and pools are updated in place.

Point-in-time reads keep superseded leaf versions for ``retain_epochs``
flush cycles (``repro_torch.core.epoch``).  TTL deadlines live in a host
sidecar (``repro_torch.core.ttl``) that filters reads and drives
``ttl_sweep``.  Chain compaction, slice migration (``extract_slice`` /
``ingest_slice``) and the async write fast path (``write_issue`` /
``write_finalize``) follow the reference method by method.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import api, hotcache, insert_buffer, lookup, patch, scancache, stitch
from .api import RangeResult
from .epoch import EpochManager, EpochRetiredError
from .hotcache import CacheConfig, CacheState
from .keys import KEY_MAX, join_u64, limbs_to_tensor, split_u64
from .lookup import IB_DEL, IB_PUT, InsertBuffers
from .scancache import ScanCacheConfig, ScanCacheState
from .spans import SpanTable, clock, recording, span
from .tree import SEG_CAP, TreeConfig, TreeImage, build_image
from .ttl import TTLTracker
from ..device import resolve_device
from ..kernels import ops, range_pack

STATUS_OK = insert_buffer.STATUS_OK
STATUS_RETRY = insert_buffer.STATUS_RETRY


@dataclass
class StoreStats:
    waves: int = 0
    gets: int = 0
    puts: int = 0
    deletes: int = 0
    ranges: int = 0
    cache_hits: int = 0
    cache_probes: int = 0
    patches_update: int = 0
    patches_structural: int = 0
    new_leaves: int = 0
    stitched_bytes: int = 0  # total batch bytes (host + DPA paths)
    stitched_dpa_bytes: int = 0  # host->DPA bytes (the 120 MB/s path)
    bulk_load_bytes: int = 0
    bulk_load_dpa_bytes: int = 0
    retries: int = 0
    reclaimed: int = 0
    # a flush *cycle* drains some set of full buffers; each COPY+CONNECT
    # transaction applied to the device counts one stitch_apply.  Batched
    # mode: applies == cycles.  Per-leaf oracle mode: applies >= cycles.
    flush_cycles: int = 0
    stitch_applies: int = 0
    patched_leaves: int = 0
    # scan-anchor cache (RANGE descent skip) + continuation accounting
    scan_probes: int = 0  # fresh-descent RANGE rows probed against the cache
    scan_hits: int = 0  # rows whose descent the anchor cache skipped
    scan_invalidated: int = 0  # anchors dropped by stitch-cycle invalidation
    scan_cursor_admits: int = 0  # truncated-scan cursors admitted as anchors
    range_rounds_in_mesh: int = 0  # continuation rounds after the first
    range_reissue_rounds: int = 0  # host-resumed calls (start_leaves given)
    range_truncated: int = 0  # rows returned truncated (bounded max_rounds)
    # chain compaction: empty routing stubs removed from the leaf chain
    stub_leaves_compacted: int = 0
    # slice migration: keys shipped out of / into this store
    migrated_out_keys: int = 0
    migrated_in_keys: int = 0
    # wave-pipeline timing ledger (field parity with the reference)
    wave_issue_ns: int = 0
    wave_drain_ns: int = 0


@dataclass
class _GetWave:
    """In-flight GET wave: device tensors only."""

    n: int
    vhi: object
    vlo: object
    found: object
    hits: Optional[object]  # cache hit mask, or None when the cache is off
    # host-side TTL expiry mask (None when no deadline can apply), taken at
    # issue time against the live tracker or the epoch's frozen snapshot
    expired: Optional[np.ndarray] = None


@dataclass
class _WriteWave:
    """In-flight fast-path write wave (all lanes proven to land)."""

    n: int
    status: object  # device status tensor (n,), all-OK by construction


@dataclass
class _RangeWave:
    """In-flight RANGE wave: its packed results on their way into a host
    staging buffer (kernel B5, one copy), or its answer already whole."""

    n: int
    limit: int
    arity: int
    resumed: bool  # start_leaves was given (host-orchestrated re-issue)
    staged: Optional[Tuple[torch.Tensor, Optional[torch.cuda.Event]]] = None
    rounds: int = 0
    as_of: Optional[int] = None
    # the answer of a wave with no device part: a degenerate one (limit<=0
    # / n==0) or a prebaked one (the TTL refill loop runs at issue time)
    result: Optional[RangeResult] = None


class _Staging:
    """Host staging buffers for the scan waves' packed results: a free list
    of uint8 buffers, page-locked when the store is on a card, each with the
    event of its last copy.  A wave takes one at issue and gives it back at
    drain, so waves issued and not yet drained never share one, however
    many a caller keeps in flight; a buffer grows to the largest wave it
    has carried."""

    def __init__(self, device: torch.device):
        self.card = device.type == "cuda"
        self._free: List[Tuple[torch.Tensor, Optional[torch.cuda.Event]]] = []

    def stage(self, packed: torch.Tensor):
        """Copy ``packed`` into a free buffer: asynchronously from a card,
        followed by the buffer's event."""
        buf = self._free.pop() if self._free else None
        if buf is None or buf[0].numel() < packed.numel():
            buf = (
                torch.empty(packed.numel(), dtype=torch.uint8, pin_memory=self.card),
                torch.cuda.Event() if self.card else None,
            )
        host, done = buf
        host[: packed.numel()].copy_(packed, non_blocking=self.card)
        if done is not None:
            done.record(torch.cuda.current_stream(packed.device))
        return buf

    def take(self, buf) -> torch.Tensor:
        """The buffer, once its copy has landed."""
        if buf[1] is not None:
            buf[1].synchronize()
        return buf[0]

    def release(self, buf) -> None:
        self._free.append(buf)


class DPAStore:
    """Single-shard DPA-Store on one device."""

    def __init__(
        self,
        keys: np.ndarray,
        vals: np.ndarray,
        tree_cfg: TreeConfig = TreeConfig(),
        cache_cfg: Optional[CacheConfig] = CacheConfig(),
        bulk_load_via_stitch: bool = False,
        epoch_grace: int = 2,
        batched_patch: bool = True,
        scan_cache_cfg: Optional[ScanCacheConfig] = ScanCacheConfig(),
        retain_epochs: int = 0,
        device=None,
    ):
        # batched_patch=True (default): a flush cycle plans every full leaf
        # into ONE merged stitch batch and applies it as a single COPY+CONNECT
        # transaction.  False keeps the per-leaf stream (the semantic oracle).
        self.device = resolve_device(device)
        self.batched_patch = batched_patch
        keys = np.asarray(keys, dtype=np.uint64)
        vals = np.asarray(vals, dtype=np.uint64)
        if not np.all(keys < KEY_MAX):
            raise ValueError("2^64-1 is a reserved sentinel")
        self.cfg = tree_cfg
        # host spans of the build and of every wave (core/spans.py)
        self.spans = SpanTable()
        self._flush_spans = (self.spans.entry("kv/flush/plan"), self.spans.entry("kv/flush/apply"))
        with span(self.spans, "kv/build/image"):
            self.image: TreeImage = build_image(keys, vals, tree_cfg)
        with span(self.spans, "kv/build/bulk_batch"):
            bulk = stitch.bulk_load_batch(self.image)
        self.stats = StoreStats()
        self.stats.bulk_load_bytes = bulk.payload_bytes()
        self.stats.bulk_load_dpa_bytes = bulk.dpa_bytes()
        n_leaves = self.image.leaf_anchor.shape[0]
        if bulk_load_via_stitch:
            tree0 = stitch.apply_copies(stitch.empty_device_tree(self.image, self.device), bulk)
            self.tree, _ = stitch.apply_connects(
                tree0,
                lookup.make_insert_buffers(n_leaves, tree_cfg.ib_cap, self.device),
                bulk,
            )
        else:
            with span(self.spans, "kv/build/to_device"):
                self.tree = self.image.to_device(self.device)
        self.ib: InsertBuffers = lookup.make_insert_buffers(n_leaves, tree_cfg.ib_cap, self.device)
        self.cache_cfg = cache_cfg
        self.cache: Optional[CacheState] = (
            hotcache.make_cache(cache_cfg, self.device) if cache_cfg else None
        )
        # scan-anchor cache: key -> leaf where the descent bottomed out;
        # invalidated through the epoch manager's quarantine listener
        self.scan_cache_cfg = scan_cache_cfg
        self.scan_cache: Optional[ScanCacheState] = (
            scancache.make_cache(scan_cache_cfg, self.device) if scan_cache_cfg else None
        )
        self._stale_anchor_leaves: List[int] = []
        # retain_epochs > 0 keeps every superseded leaf version addressable
        # for that many stitch cycles (``as_of`` reads through
        # _resolve_table); it costs pool headroom and makes every patch
        # copy-on-write
        self.retain_epochs = retain_epochs
        self.epochs = EpochManager(grace=epoch_grace, retain=retain_epochs)
        self.epochs.on_defer = self._note_deferred_free
        # TTL sidecar (logical clock) + frozen per-cycle deadline snapshots
        # for as_of reads; both empty until the first ``put(ttl=...)``
        self.ttl = TTLTracker()
        self._ttl_snaps: Dict[int, Tuple[Dict[int, int], int]] = {}
        # host shadow of ib.count for the write fast path (None = stale;
        # every other insert-buffer mutation resets it)
        self._ib_shadow: Optional[np.ndarray] = None
        # page-locked landing buffers of the scan waves' drains
        self._staging = _Staging(self.device)

    # ------------------------------------------------------------------ util
    @property
    def depth(self) -> int:
        return self.image.depth

    def span_totals(self) -> Dict[str, Tuple[int, int]]:
        """The store's host spans: ``name -> (ns, calls)``."""
        return self.spans.totals()

    def _limbs(self, keys_u64: np.ndarray):
        """u64 keys -> (khi, klo) int32-held limb tensors on the device."""
        limbs = limbs_to_tensor(split_u64(np.asarray(keys_u64, dtype=np.uint64)), self.device)
        return limbs[:, 0].contiguous(), limbs[:, 1].contiguous()

    def _steer(self, khi, klo):
        if self.cache_cfg is None:
            return torch.zeros_like(khi)
        return hotcache.steer(khi, klo, self.cache_cfg.n_threads)

    def _end_wave(self):
        self.stats.waves += 1
        self.epochs.advance()
        self.stats.reclaimed += self.epochs.reclaim(self.image)

    # -------------------------------------------- scan-anchor invalidation
    def _note_deferred_free(self, pool: str, idx: int) -> None:
        """EpochManager.on_defer listener: collect leaves a stitch cycle
        obsoleted (runs right after the CONNECT)."""
        if pool == "leaves" and self.scan_cache is not None:
            self._stale_anchor_leaves.append(int(idx))

    def _apply_scan_invalidation(self) -> None:
        """Drop every cached scan anchor whose leaf this cycle replaced,
        before any later wave can probe the cache."""
        if self.scan_cache is None or not self._stale_anchor_leaves:
            self._stale_anchor_leaves.clear()
            return
        ids = torch.tensor(self._stale_anchor_leaves, dtype=torch.int32, device=self.device)
        self._stale_anchor_leaves.clear()
        self.scan_cache, n = scancache.invalidate_leaves(self.scan_cache, ids)
        self.stats.scan_invalidated += n

    # ------------------------------------------- point-in-time read window
    def snapshot_epoch(self) -> int:
        """Flush staged writes and return the version epoch naming the
        current stitched state — the handle for ``as_of`` reads.  Raises
        :class:`EpochRetiredError` when the store keeps no window."""
        self.flush()
        if self.epochs.retain <= 0:
            raise EpochRetiredError("snapshot_epoch: store was built with retain_epochs=0")
        return self.epochs.cycle

    def _resolve_table(self, e: int):
        """Per-epoch leaf-id overlay ``res[l] -> l'``: every leaf id mapped
        to the version of its window live at epoch ``e`` (walk ``ver_prev``
        while the version was born after ``e``).  A host numpy fixpoint,
        shipped as one int32 tensor.  Entries for free-pool ids may be
        garbage; no current leaf gathers them."""
        vb, vp = self.image.ver_birth, self.image.ver_prev
        res = np.arange(vb.shape[0], dtype=np.int32)
        for _ in range(max(self.epochs.retain, 1) + 1):
            need = (vb[res] > e) & (vp[res] >= 0)
            if not need.any():
                break
            res[need] = vp[res[need]]
        return torch.from_numpy(res).to(self.device)

    def _note_cycle_end(self) -> None:
        """Per-cycle retention bookkeeping (after ``end_cycle``): freeze the
        TTL deadlines for the cycle that just completed, and age frozen
        snapshots out with the retention horizon."""
        # once any snapshot exists keep freezing even when the tracker
        # empties, so later epochs supersede stale deadlines
        if self.retain_epochs > 0 and (self.ttl or self._ttl_snaps):
            self._ttl_snaps[self.epochs.cycle] = self.ttl.freeze()
        if self._ttl_snaps:
            h = self.epochs.horizon
            for c in [c for c in self._ttl_snaps if c <= h]:
                del self._ttl_snaps[c]

    def _ttl_snap_for(self, e: int):
        """Frozen TTL snapshot governing epoch ``e``: the newest freeze at or
        before ``e``; None when no deadline existed then."""
        cands = [c for c in self._ttl_snaps if c <= e]
        return self._ttl_snaps[max(cands)] if cands else None

    # ------------------------------------------------------------------ GET
    def get(
        self,
        keys=None,
        *,
        epoch: Optional[int] = None,
        as_of: Optional[int] = None,
        **legacy,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched point lookup: returns (values u64, found bool).  ``epoch``
        exists for signature parity with the sharded tiers (only ``None``).
        ``as_of=<version epoch>`` (from :meth:`snapshot_epoch`) serves the
        lookup from the retained window; outside it
        :class:`EpochRetiredError` is raised."""
        keys = api.take_legacy("get", legacy, keys, "keys", "keys_u64")
        api.reject_unknown("get", legacy)
        return self.get_finalize(self.get_issue(keys, epoch=epoch, as_of=as_of))

    def get_issue(self, keys, *, epoch: Optional[int] = None, as_of: Optional[int] = None) -> _GetWave:
        """Issue half of GET: cache probe, GET kernel, cache admit — returns
        without blocking on device results.  An ``as_of`` read makes no
        cache probe and no admit."""
        if epoch is not None:
            raise ValueError("single-store GET has no routing epochs (epoch must be None)")
        keys_u64 = np.asarray(keys, dtype=np.uint64)
        n = keys_u64.size
        if as_of is not None:
            khi, klo = self._limbs(keys_u64)
            e = self.epochs.check_retained(as_of)
            vhi, vlo, found = lookup.get_batch_versioned(
                self.tree,
                self._resolve_table(e),
                khi,
                klo,
                depth=self.depth,
                eps_inner=self.cfg.eps_inner,
                eps_leaf=self.cfg.eps_leaf,
            )
            snap = self._ttl_snap_for(e)
            expired = TTLTracker.expired_at(snap, keys_u64) if snap is not None else None
            self.stats.gets += n
            self._end_wave()
            return _GetWave(n=n, vhi=vhi, vlo=vlo, found=found, hits=None, expired=expired)
        use_cache = self.cache is not None
        with span(self.spans, "kv/get/build"):
            khi, klo = self._limbs(keys_u64)
            if use_cache:
                tid = self._steer(khi, klo)
        with span(self.spans, "kv/get/launch"):
            if use_cache:
                c_hit, c_vhi, c_vlo = ops.cache_probe(self.cache, tid, khi, klo, cfg=self.cache_cfg)
            vhi, vlo, found = ops.get(
                self.tree,
                self.ib,
                khi,
                klo,
                depth=self.depth,
                eps_inner=self.cfg.eps_inner,
                eps_leaf=self.cfg.eps_leaf,
            )
            hits = None
            if use_cache:
                out_vhi = torch.where(c_hit, c_vhi, vhi)
                out_vlo = torch.where(c_hit, c_vlo, vlo)
                out_found = c_hit | found
                self.cache = hotcache.admit(
                    self.cache,
                    tid,
                    khi,
                    klo,
                    vhi,
                    vlo,
                    found & ~c_hit,
                    cfg=self.cache_cfg,
                    wave=self.stats.waves & 0xFFFFFFFF,
                )
                hits = c_hit
                self.stats.cache_probes += n
            else:
                out_vhi, out_vlo, out_found = vhi, vlo, found
        self.stats.gets += n
        expired = self.ttl.is_expired_np(keys_u64) if self.ttl else None
        self._end_wave()
        return _GetWave(n=n, vhi=out_vhi, vlo=out_vlo, found=out_found, hits=hits, expired=expired)

    def get_finalize(self, w: _GetWave) -> Tuple[np.ndarray, np.ndarray]:
        """Drain half of GET: blocking gather + host epilogue."""
        with span(self.spans, "kv/get/copy"):
            if w.hits is not None:
                self.stats.cache_hits += int(w.hits.sum())
            vals = join_u64(torch.stack([w.vhi, w.vlo], dim=-1).cpu().numpy())
            found = w.found.cpu().numpy()
        if w.expired is not None:
            # TTL: a key past its deadline reads as absent (the sweep
            # deletes it physically later)
            found = found & ~w.expired
        # protocol contract: not-found rows carry 0, never slot residue
        vals[~found] = 0
        return vals, found

    # ---------------------------------------------------------------- writes
    def _write(self, keys_u64, vals_u64, op_code: int, auto_retry: bool = True) -> np.ndarray:
        keys_u64 = np.asarray(keys_u64, dtype=np.uint64)
        if not np.all(keys_u64 < KEY_MAX):
            raise ValueError("2^64-1 is a reserved sentinel")
        vals_u64 = (
            np.zeros_like(keys_u64) if vals_u64 is None else np.asarray(vals_u64, dtype=np.uint64)
        )
        n = keys_u64.size
        statuses = np.full(n, STATUS_RETRY, dtype=np.int32)
        pending = np.arange(n)
        first = True
        stalled = 0
        while pending.size and (auto_retry or first):
            first = False
            st = self._write_wave(keys_u64[pending], vals_u64[pending], op_code)
            statuses[pending] = st
            self._process_full_leaves()
            next_pending = pending[st == STATUS_RETRY]
            if next_pending.size == pending.size:
                # no lane landed: drain the responsible buffers so the
                # re-send can succeed (the client re-sends after a timeout)
                stalled += 1
                self._flush_leaves_of(keys_u64[next_pending])
                if stalled >= 3:  # defensive; cannot happen after a flush
                    break
            else:
                stalled = 0
            if next_pending.size:
                self.stats.retries += next_pending.size
            pending = next_pending
        return statuses

    def _append(self, keys_u64, vals_u64, op_code: int):
        """One insert-buffer append wave (descent, append, cache
        invalidation, wave end); returns the device status tensor."""
        n = keys_u64.size
        khi, klo = self._limbs(keys_u64)
        vhi, vlo = self._limbs(vals_u64)
        leaf = lookup.traverse(self.tree, khi, klo, depth=self.depth, eps_inner=self.cfg.eps_inner)
        op = torch.full((n,), op_code, dtype=torch.int32, device=self.device)
        active = torch.ones(n, dtype=torch.bool, device=self.device)
        self.ib, status = insert_buffer.append_wave(self.ib, leaf, khi, klo, vhi, vlo, op, active)
        if self.cache is not None:
            # UPDATE/DELETE invalidate cached entries (paper Sec 3.1.2)
            tid = self._steer(khi, klo)
            self.cache = hotcache.invalidate(self.cache, tid, khi, klo, active, cfg=self.cache_cfg)
        self._end_wave()
        return status

    def _write_wave(self, keys_u64, vals_u64, op_code: int) -> np.ndarray:
        status = self._append(keys_u64, vals_u64, op_code)
        self._ib_shadow = None  # serial append: the shadow is stale
        return status.cpu().numpy()

    # ------------------------------------------- async write fast path
    def _write_plan(self, keys_u64: np.ndarray):
        """Prove on the host that a write wave lands every lane WITHOUT
        filling any insert buffer to ``ib_cap``, through ``image.find_leaf``
        (the host replica of the device descent) and the host shadow of
        ``ib.count``.  Returns the per-leaf append counts, or ``None`` when a
        touched buffer could reach the cap: the caller then takes the serial
        path, so stitch cycles land at the serial op-stream points."""
        with span(self.spans, "kv/write/proof"):
            if self._ib_shadow is None:
                self._ib_shadow = self._ib_counts().copy()
            leaves = np.fromiter(
                (self.image.find_leaf(k)[0] for k in keys_u64), dtype=np.int64, count=keys_u64.size
            )
            adds = np.zeros_like(self._ib_shadow)
            np.add.at(adds, leaves, 1)
            touched = np.unique(leaves)
            # strict <: the wave must also leave every buffer BELOW the cap,
            # else the serial path's post-wave _process_full_leaves would stitch
            if np.any(self._ib_shadow[touched] + adds[touched] >= self.cfg.ib_cap):
                return None
            return adds

    def write_issue(self, op: str, keys, vals=None) -> Optional[_WriteWave]:
        """Issue half of PUT/DELETE on the proven-safe fast path only.
        Returns ``None`` when the wave needs the serial path (a buffer could
        fill, or a lane could RETRY)."""
        if op not in ("put", "delete"):
            raise ValueError(f"write_issue: op must be 'put' or 'delete', not {op!r}")
        keys_u64 = np.asarray(keys, dtype=np.uint64)
        if not np.all(keys_u64 < KEY_MAX):
            raise ValueError("2^64-1 is a reserved sentinel")
        n = keys_u64.size
        if n == 0:
            return _WriteWave(n=0, status=np.zeros(0, dtype=np.int32))
        adds = self._write_plan(keys_u64)
        if adds is None:
            return None
        vals_u64 = np.zeros_like(keys_u64) if vals is None else np.asarray(vals, dtype=np.uint64)
        with span(self.spans, "kv/write/fast"):
            status = self._append(keys_u64, vals_u64, IB_PUT if op == "put" else IB_DEL)
        self._ib_shadow += adds  # exact: every lane proven to land
        if op == "put":
            self.stats.puts += n
            # a fast-path PUT carries no ttl: it clears stale deadlines
            self.ttl.note_put(keys_u64, None)
        else:
            self.stats.deletes += n
            self.ttl.note_delete(keys_u64)
        return _WriteWave(n=n, status=status)

    def write_finalize(self, w: _WriteWave) -> np.ndarray:
        """Drain half of PUT/DELETE: the device statuses (all OK by the
        issue-time proof, but the device tensor is authoritative)."""
        if w.n == 0:
            return np.asarray(w.status)
        return w.status.cpu().numpy()

    def put(
        self,
        keys=None,
        vals=None,
        *args,
        auto_retry: bool = True,
        ttl: Optional[int] = None,
        **legacy,
    ) -> np.ndarray:
        """INSERT or UPDATE (the buffer treats both as PUT; the patcher
        classifies the patch).  ``ttl=K`` stamps each key that landed with
        the logical-clock deadline ``now + K``; ``ttl=None`` never expires
        and clears any deadline an earlier write left."""
        keys = api.take_legacy("put", legacy, keys, "keys", "keys_u64")
        vals = api.take_legacy("put", legacy, vals, "vals", "vals_u64")
        api.reject_unknown("put", legacy)
        if args:  # legacy positional auto_retry
            api.warn_legacy("put", "positional auto_retry", "auto_retry=...")
            (auto_retry,) = args
        st = self._write(keys, vals, IB_PUT, auto_retry)
        keys_u64 = np.asarray(keys, dtype=np.uint64)
        self.ttl.note_put(keys_u64[st == STATUS_OK], ttl)
        self.stats.puts += keys_u64.size
        return st

    insert = put
    update = put

    def delete(self, keys=None, *args, auto_retry: bool = True, **legacy) -> np.ndarray:
        keys = api.take_legacy("delete", legacy, keys, "keys", "keys_u64")
        api.reject_unknown("delete", legacy)
        if args:  # legacy positional auto_retry
            api.warn_legacy("delete", "positional auto_retry", "auto_retry=...")
            (auto_retry,) = args
        st = self._write(keys, None, IB_DEL, auto_retry)
        keys_u64 = np.asarray(keys, dtype=np.uint64)
        self.ttl.note_delete(keys_u64[st == STATUS_OK])
        self.stats.deletes += keys_u64.size
        return st

    # ---------------------------------------------------------------- range
    def range(
        self,
        k_min=None,
        limit: int = 10,
        *args,
        k_max=None,
        epoch: Optional[int] = None,
        as_of: Optional[int] = None,
        max_leaves: int = 4,
        **legacy,
    ) -> RangeResult:
        """RANGE(k_min, limit) per request: a :class:`RangeResult` with
        ``keys (B, limit)``, ``vals (B, limit)``, ``counts (B,)`` —
        ascending, live entries only (zeros past ``counts``) — which still
        tuple-unpacks at the legacy 3-arity.  ``k_max`` (scalar or per-row
        u64, exclusive) clips the scan window.  Truncated rows resume from
        their cursor until every row hit ``limit`` or exhausted the chain.
        ``as_of`` reads the retained snapshot of that version epoch."""
        k_min = api.take_legacy("range", legacy, k_min, "k_min", "start_keys_u64")
        api.reject_unknown("range", legacy)
        if args:  # legacy positional max_leaves
            api.warn_legacy("range", "positional max_leaves", "max_leaves=...")
            (max_leaves,) = args
        if epoch is not None:
            raise ValueError("single-store RANGE has no routing epochs (epoch must be None)")
        res = self.range_with_state(
            k_min, limit=limit, max_leaves=max_leaves, k_max=k_max, as_of=as_of
        )
        return RangeResult(
            keys=res.keys,
            vals=res.vals,
            counts=res.counts,
            truncated=res.truncated,
            cursor_leaf=res.cursor_leaf,
            cursor_key=res.cursor_key,
            rounds=res.rounds,
            stats=res.stats,
            _arity=3,
        )

    def _scan_start(self, khi, klo, resume_np: np.ndarray):
        """Start leaf of each lane: continuation cursor if resuming, cached
        anchor on a hit, learned-index descent otherwise.  The descent is
        skipped entirely when no lane needs it."""
        start = torch.from_numpy(resume_np).to(self.device)  # -1 = fresh
        fresh_np = resume_np < 0
        hit_np = np.zeros_like(fresh_np)
        tid = None
        if self.scan_cache is not None and fresh_np.any():
            # steer with the SCAN cache's thread geometry
            tid = hotcache.steer(khi, klo, self.scan_cache_cfg.n_threads)
            hit, cleaf = ops.scan_anchor_probe(
                self.scan_cache, tid, khi, klo, cfg=self.scan_cache_cfg
            )
            hit_np = hit.cpu().numpy() & fresh_np
            self.stats.scan_probes += int(fresh_np.sum())
            self.stats.scan_hits += int(hit_np.sum())
            use = (start < 0) & torch.from_numpy(hit_np).to(self.device)
            start = torch.where(use, cleaf, start)
        need_traverse = fresh_np & ~hit_np
        tstart = None
        if need_traverse.any():
            tstart = lookup.traverse(
                self.tree, khi, klo, depth=self.depth, eps_inner=self.cfg.eps_inner
            )
            start = torch.where(start < 0, tstart, start)
        if self.scan_cache is not None and tstart is not None:
            # admit the fresh descents the cache missed
            self.scan_cache = scancache.admit(
                self.scan_cache,
                tid,
                khi,
                klo,
                tstart,
                torch.from_numpy(need_traverse).to(self.device),
                cfg=self.scan_cache_cfg,
                wave=self.stats.waves & 0xFFFFFFFF,
                epoch=self.stats.flush_cycles,
            )
        return start

    def range_with_state(
        self,
        start_keys_u64,
        limit: int = 10,
        max_leaves: int = 4,
        max_rounds: Optional[int] = None,
        start_leaves: Optional[np.ndarray] = None,
        k_max=None,
        as_of: Optional[int] = None,
    ) -> RangeResult:
        """RANGE with explicit continuation state: a :class:`RangeResult`
        carrying (keys, vals, counts, truncated, cursor_leaf, cursor_key) —
        tuple-unpacks at the legacy 6-arity.  ``max_rounds=None`` loops until
        limit/exhaustion/window; a bounded ``max_rounds`` returns truncated
        rows with the cursor to resume from (``start_leaves`` accepts those
        cursors back, -1 = fresh descent).  ``as_of`` pins the version epoch
        for the whole call."""
        return self.range_finalize(
            self.range_issue(
                start_keys_u64,
                limit=limit,
                k_max=k_max,
                max_leaves=max_leaves,
                max_rounds=max_rounds,
                start_leaves=start_leaves,
                arity=6,
                as_of=as_of,
            )
        )

    def range_issue(
        self,
        k_min,
        limit: int = 10,
        *,
        k_max=None,
        epoch: Optional[int] = None,
        max_leaves: int = 4,
        max_rounds: Optional[int] = None,
        start_leaves: Optional[np.ndarray] = None,
        arity: int = 3,
        as_of: Optional[int] = None,
        _raw: bool = False,
    ) -> _RangeWave:
        """Issue half of RANGE: anchor-cache start resolution + the range
        loop (kernel walk, merge epilogue, continuation rounds).

        ``as_of=<version epoch>`` walks the retained snapshot instead of the
        live tree (plain descent, resolve-table gathers, no anchor cache).
        When a TTL filter applies (a non-empty live tracker, or the epoch's
        frozen snapshot for ``as_of``), the wave runs its refill loop at
        issue time and comes back prebaked; ``_raw=True`` is that loop's
        unfiltered inner call."""
        if max_rounds is not None and max_rounds < 1:
            raise ValueError(
                "max_rounds: None = loop until limit/exhaustion/window; a "
                "bound must be >= 1 (0 would silently alias the unbounded loop)"
            )
        if epoch is not None:
            raise ValueError("single-store RANGE has no routing epochs (epoch must be None)")
        if as_of is not None:
            as_of = self.epochs.check_retained(as_of)
        start_keys_u64 = np.asarray(k_min, dtype=np.uint64)
        n = start_keys_u64.size
        lim = max(limit, 0)
        if not _raw and n and lim:
            if as_of is not None:
                snap = self._ttl_snap_for(as_of)
                expired_fn = (lambda k: TTLTracker.expired_at(snap, k)) if snap is not None else None
            else:
                expired_fn = self.ttl.is_expired_np if self.ttl else None
            if expired_fn is not None:
                return self._range_filtered(
                    start_keys_u64,
                    limit=limit,
                    k_max=k_max,
                    max_leaves=max_leaves,
                    arity=arity,
                    as_of=as_of,
                    expired_fn=expired_fn,
                )
        w = _RangeWave(n=n, limit=limit, arity=arity, resumed=start_leaves is not None)
        self.stats.ranges += n
        if n == 0 or limit <= 0:
            w.result = RangeResult(
                keys=np.zeros((n, lim), dtype=np.uint64),
                vals=np.zeros((n, lim), dtype=np.uint64),
                counts=np.zeros(n, dtype=np.int64),
                truncated=np.zeros(n, dtype=bool),
                cursor_leaf=np.full(n, -1, dtype=np.int32),
                cursor_key=start_keys_u64.copy(),
                rounds=0,
                stats={},
                _arity=arity,
            )
            return w
        if start_leaves is not None:
            self.stats.range_reissue_rounds += 1
        khi, klo = self._limbs(start_keys_u64)
        resume = np.full(n, -1, dtype=np.int32)
        if start_leaves is not None:
            resume[:] = np.asarray(start_leaves, dtype=np.int32)
        ubs = np.full(n, KEY_MAX, dtype=np.uint64)  # sentinel: no clip
        if k_max is not None:
            ubs[:] = np.asarray(k_max, dtype=np.uint64)
        ub_hi, ub_lo = self._limbs(ubs)
        max_rounds = 0 if max_rounds is None else max_rounds
        if as_of is not None:
            # versioned walk: plain descent for fresh rows (the anchor cache
            # serves live pagination; versioned reads must not churn it)
            w.as_of = as_of
            start = torch.from_numpy(resume).to(self.device)
            if (resume < 0).any():
                tstart = lookup.traverse(
                    self.tree, khi, klo, depth=self.depth, eps_inner=self.cfg.eps_inner
                )
                start = torch.where(start < 0, tstart, start)
            *out, w.rounds = lookup.range_batch_loop_versioned(
                self.tree,
                self._resolve_table(as_of),
                start,
                khi,
                klo,
                ub_hi,
                ub_lo,
                limit=limit,
                max_leaves=max_leaves,
                max_rounds=max_rounds,
            )
            self._stage_range(w, out, khi, klo)
            self._end_wave()
            return w
        with span(self.spans, "kv/range/start"):
            start = self._scan_start(khi, klo, resume)
        *out, w.rounds = ops.range_scan_loop(
            self.tree,
            self.ib,
            khi,
            klo,
            depth=self.depth,
            eps_inner=self.cfg.eps_inner,
            limit=limit,
            max_leaves=max_leaves,
            max_rounds=max_rounds,
            start_leaf=start,
            ub_hi=ub_hi,
            ub_lo=ub_lo,
            spans=self.spans,
        )
        self._stage_range(w, out, khi, klo)
        self._end_wave()
        return w

    def _stage_range(self, w: _RangeWave, out, khi, klo) -> None:
        """Pack the range loop's ``out`` (keys, vals, valid, truncated,
        cursor) into the host's layout (kernel B5) and enqueue its copy into
        a staging buffer: the wave's whole device part ends here."""
        rk, rv, valid, trunc, cursor = out
        with span(self.spans, "kv/range/pack"):
            packed = ops.range_pack(rk, rv, valid, trunc, cursor, khi, klo, limit=w.limit)
            w.staged = self._staging.stage(packed)

    def range_finalize(self, w: _RangeWave) -> RangeResult:
        """Drain half of RANGE: the staged results copied out into the
        wave's arrays, and pagination cursor admission (fresh live scans
        only)."""
        if w.result is not None:  # degenerate or prebaked: no device part
            return w.result
        n, limit = w.n, w.limit
        staged, w.staged = w.staged, None
        if staged is None:
            raise RuntimeError("range_finalize: this wave was already drained")
        self.stats.range_rounds_in_mesh += max(w.rounds - 1, 0)
        with span(self.spans, "kv/range/copy"):
            host = self._staging.take(staged)
            keys_out, vals_out, counts, trunc_out, cur_leaf_out, cur_key_out = range_pack.unpack(
                host, n, limit
            )
            self._staging.release(staged)
        with span(self.spans, "kv/range/epilogue"):
            self.stats.range_truncated += int(trunc_out.sum())
        if not w.resumed and w.as_of is None:
            # only fresh client-entry scans admit their cursors: a resumed
            # call is an orchestration round whose cursors nobody probes
            with span(self.spans, "kv/range/admit"):
                self._admit_cursor_anchors(trunc_out, cur_key_out)
        stats = {"rounds_in_mesh": max(w.rounds - 1, 0), "reissue": int(w.resumed)}
        if w.as_of is not None:
            stats["as_of"] = int(w.as_of)
        return RangeResult(
            keys=keys_out,
            vals=vals_out,
            counts=counts,
            truncated=trunc_out,
            cursor_leaf=cur_leaf_out,
            cursor_key=cur_key_out,
            rounds=w.rounds,
            stats=stats,
            _arity=w.arity,
        )

    def _admit_cursor_anchors(self, trunc: np.ndarray, last_keys: np.ndarray):
        """Scan-anchor cursor admission (pagination pre-warm): the client's
        next page is ``RANGE(last_key + 1)`` — admit that key now, mapped to
        its host-replica descent leaf, so the follow-up wave skips the
        device descent."""
        if self.scan_cache is None or not self.scan_cache_cfg.admit_cursors:
            return
        m = np.where(trunc)[0]
        if m.size == 0:
            return
        nxt = last_keys[m] + np.uint64(1)
        nxt = nxt[nxt < KEY_MAX]  # 2^64-1 is the reserved sentinel
        if nxt.size == 0:
            return
        leaves = np.array([self.image.find_leaf(k)[0] for k in nxt], dtype=np.int32)
        khi, klo = self._limbs(nxt)
        tid = hotcache.steer(khi, klo, self.scan_cache_cfg.n_threads)
        hit, _ = ops.scan_anchor_probe(self.scan_cache, tid, khi, klo, cfg=self.scan_cache_cfg)
        eligible = ~hit
        self.scan_cache = scancache.admit(
            self.scan_cache,
            tid,
            khi,
            klo,
            torch.from_numpy(leaves).to(self.device),
            eligible,
            cfg=self.scan_cache_cfg,
            wave=self.stats.waves & 0xFFFFFFFF,
            epoch=self.stats.flush_cycles,
        )
        self.stats.scan_cursor_admits += int(eligible.sum())

    def _range_filtered(
        self,
        start_keys_u64: np.ndarray,
        *,
        limit: int,
        k_max,
        max_leaves: int,
        arity: int,
        as_of: Optional[int],
        expired_fn,
    ) -> _RangeWave:
        """TTL-filtered RANGE: a refill loop over the unfiltered machinery.
        Expired keys are dropped after the scan, so a row whose unfiltered
        walk filled ``limit`` may come back short; such rows re-issue from
        the last pre-filter key + 1 until the limit fills or the window or
        chain runs out.  Runs at issue time (each inner call is one wave)
        and returns a prebaked wave; rows are never reported truncated."""
        n = start_keys_u64.size
        keys_out = np.zeros((n, limit), dtype=np.uint64)
        vals_out = np.zeros((n, limit), dtype=np.uint64)
        counts = np.zeros(n, dtype=np.int64)
        cur_key_out = start_keys_u64.copy()
        kmax_arr = np.full(n, KEY_MAX, dtype=np.uint64)
        if k_max is not None:
            kmax_arr[:] = np.asarray(k_max, dtype=np.uint64)
        cur_k = start_keys_u64.copy()
        need = np.ones(n, dtype=bool)
        rounds = 0
        while need.any():
            idxs = np.where(need)[0]
            r = self.range_finalize(
                self.range_issue(
                    cur_k[idxs],
                    limit=limit,
                    k_max=kmax_arr[idxs],
                    max_leaves=max_leaves,
                    arity=6,
                    as_of=as_of,
                    _raw=True,
                )
            )
            rounds += max(int(r.rounds), 1)
            for j, i in enumerate(idxs):
                rc = int(r.counts[j])
                rk = r.keys[j, :rc]
                rv = r.vals[j, :rc]
                keep = ~expired_fn(rk)
                rk, rv = rk[keep], rv[keep]
                space = limit - int(counts[i])
                take = min(rk.size, space)
                if take:
                    at = int(counts[i])
                    keys_out[i, at : at + take] = rk[:take]
                    vals_out[i, at : at + take] = rv[:take]
                    counts[i] += take
                    cur_key_out[i] = rk[take - 1]
                if counts[i] >= limit or rc < limit:
                    # filled, or the unfiltered walk exhausted the window
                    need[i] = False
                    continue
                nxt = int(r.cursor_key[j]) + 1  # last pre-filter key + 1
                if nxt >= int(kmax_arr[i]) or nxt >= int(KEY_MAX):
                    need[i] = False
                else:
                    cur_k[i] = np.uint64(nxt)
        stats = {"rounds_in_mesh": 0, "reissue": 0, "ttl_filtered": 1}
        if as_of is not None:
            stats["as_of"] = int(as_of)
        w = _RangeWave(n=n, limit=limit, arity=arity, resumed=False, as_of=as_of)
        w.result = RangeResult(
            keys=keys_out,
            vals=vals_out,
            counts=counts,
            truncated=np.zeros(n, dtype=bool),
            cursor_leaf=np.full(n, -1, dtype=np.int32),
            cursor_key=cur_key_out,
            rounds=rounds,
            stats=stats,
            _arity=arity,
        )
        return w

    # ------------------------------------------------------------ patch path
    def _ib_counts(self) -> np.ndarray:
        return self.ib.count.cpu().numpy()

    def _process_full_leaves(self) -> int:
        full = np.where(self._ib_counts() >= self.cfg.ib_cap)[0]
        return self._patch_cycle([int(l) for l in full])

    def _flush_leaves_of(self, keys_u64: np.ndarray) -> None:
        """Patch the (non-empty) buffers responsible for RETRYing keys."""
        counts = self._ib_counts()
        leaves = []
        for k in np.asarray(keys_u64, dtype=np.uint64):
            leaf, _ = self.image.find_leaf(k)
            if int(counts[leaf]) > 0 and leaf not in leaves:
                leaves.append(int(leaf))
        self._patch_cycle(leaves)

    def flush(self) -> int:
        """Patch every non-empty insert buffer as one flush cycle."""
        leaves = np.where(self._ib_counts() > 0)[0]
        return self._patch_cycle([int(l) for l in leaves])

    def _buffer_entries(self, leaves):
        """Snapshot the buffered ops of the given leaves (the 'migrate to
        host' half of the cycle); only those rows cross to the host."""
        idx = torch.tensor(leaves, dtype=torch.int64, device=self.device)
        counts = self.ib.count[idx].cpu().numpy()
        ib_keys = self.ib.keys[idx].cpu().numpy()
        ib_vals = self.ib.vals[idx].cpu().numpy()
        ib_ops = self.ib.op[idx].cpu().numpy()
        out = []
        for j in range(len(leaves)):
            cnt = int(counts[j])
            kk = join_u64(ib_keys[j, :cnt])
            vv = join_u64(ib_vals[j, :cnt])
            oo = ib_ops[j, :cnt]
            out.append([(int(k), int(v), int(o)) for k, v, o in zip(kk, vv, oo)])
        return out

    def _headroom_ok(self, planned_parents: int = 0) -> bool:
        """Can the pools absorb one more worst-case patch without recycling?
        (See the JAX store for the budget's derivation.)"""
        img, cfg = self.image, self.cfg
        a_leaf = -(-(SEG_CAP + cfg.ib_cap) // cfg.split_cap) + 1
        a_node = 4 * (planned_parents + 1) + 2 * self.image.depth + 4
        a_pivot = 7 * (planned_parents + 1) + 2 * self.image.depth + 4
        return (
            len(img.free_leaves) >= a_leaf
            and len(img.free_slots) >= a_leaf
            and len(img.free_nodes) >= a_node
            and len(img.free_pivots) >= a_pivot
        )

    def _patch_cycle(self, leaves) -> int:
        """Drain the given buffers as a flush cycle (one merged COPY+CONNECT
        transaction unless pool headroom forces a split; the per-leaf oracle
        stream when ``batched_patch`` is off)."""
        counts = self._ib_counts()
        leaves = [int(l) for l in leaves if int(counts[int(l)]) > 0]
        if not leaves:
            return 0
        return self._run_patch_cycle(list(zip(leaves, self._buffer_entries(leaves))))

    def _apply_batch(self, batch) -> None:
        """COPY then CONNECT (the stitch atomicity contract), then quarantine
        what the transaction obsoleted, drop its scan anchors and end the
        cycle — the tail every stitch transaction shares."""
        self.tree = stitch.apply_copies(self.tree, batch)
        self.tree, self.ib = stitch.apply_connects(self.tree, self.ib, batch)
        self._ib_shadow = None  # the connects drained buffers
        self.stats.stitch_applies += 1
        self.epochs.defer_free_batch(batch.frees)
        self._apply_scan_invalidation()
        self.stats.reclaimed += self.epochs.end_cycle(self.image)
        self._note_cycle_end()
        self.stats.stitched_bytes += batch.payload_bytes()
        self.stats.stitched_dpa_bytes += batch.dpa_bytes()

    def _run_patch_cycle(self, pending) -> int:
        """One flush cycle over explicit ``(leaf, entries)`` work items:
        buffer snapshots (``_patch_cycle``) or synthesized entries
        (``extract_slice``, ``ingest_slice``)."""
        n_leaves = len(pending)
        self.stats.flush_cycles += 1
        if not self.batched_patch:
            for leaf, entries in pending:
                self._patch_leaf_entries(leaf, entries)
            return n_leaves
        while pending:
            chunk_leaves = [l for l, _ in pending]
            chunk_entries = [e for _, e in pending]
            # leaves this transaction emits are born at the cycle it
            # completes as (end_cycle increments afterwards)
            self.image.version_cycle = self.epochs.cycle + 1
            if recording():
                with span(self.spans, "kv/flush/plan"):
                    result = self._plan_batch(chunk_leaves, chunk_entries)
                with span(self.spans, "kv/flush/apply"):
                    self._apply_batch(result.batch)
            else:
                # a wave can run tens of cycles: bare clock reads into the
                # spans' entries, without a ``with`` block
                t0 = clock()
                result = self._plan_batch(chunk_leaves, chunk_entries)
                t1 = clock()
                self._apply_batch(result.batch)
                t2 = clock()
                plan_e, apply_e = self._flush_spans
                plan_e[0] += t1 - t0
                plan_e[1] += 1
                apply_e[0] += t2 - t1
                apply_e[1] += 1
            pending = result.unplanned
            self.stats.patches_update += result.n_update
            self.stats.patches_structural += result.n_structural
            self.stats.new_leaves += len(result.new_leaves)
            self.stats.patched_leaves += len(result.results)
        return n_leaves

    def _plan_batch(self, leaves, entries):
        """Plan one patch transaction over ``leaves``' ``entries``."""
        return patch.plan_patch_batch(
            self.image, leaves, entries,
            headroom_ok=self._headroom_ok,
            force_structural=self.retain_epochs > 0,
        )

    def _patch_leaf_entries(self, leaf: int, entries) -> None:
        """Per-leaf oracle path: one stitch transaction per patched leaf."""
        self.image.version_cycle = self.epochs.cycle + 1
        with span(self.spans, "kv/flush/plan"):
            result = patch.plan_patch(
                self.image, leaf, entries, force_structural=self.retain_epochs > 0
            )
        with span(self.spans, "kv/flush/apply"):
            self._apply_batch(result.batch)
        self.stats.patched_leaves += 1
        if result.kind == "update":
            self.stats.patches_update += 1
        else:
            self.stats.patches_structural += 1
            self.stats.new_leaves += len(result.new_leaves)

    # ----------------------------------------- slice migration (rebalance)
    def _chain(self):
        """Leaf ids along the host chain, head first."""
        leaf = self.image.first_leaf()
        while leaf != -1:
            yield leaf
            leaf = int(self.image.leaf_next[leaf])

    def live_count(self) -> int:
        """Live keys in the stitched tree (a leaf-chain walk; buffered
        writes are not counted — flush first for an exact census)."""
        return sum(int(self.image.leaf_count[leaf]) for leaf in self._chain())

    def _slice_run(self, k_lo, k_hi) -> List[int]:
        """Leaf ids of the contiguous run intersecting ``[k_lo, k_hi)``: the
        floor leaf of ``k_lo``, then ``leaf_next`` while anchors stay below
        ``k_hi``."""
        k_lo, k_hi = np.uint64(k_lo), np.uint64(k_hi)
        if k_lo >= k_hi:
            return []
        leaf, _ = self.image.find_leaf(k_lo)
        run: List[int] = []
        while leaf != -1 and np.uint64(self.image.leaf_anchor[leaf]) < k_hi:
            run.append(int(leaf))
            leaf = int(self.image.leaf_next[leaf])
        return run

    def _slice_rows(self, k_lo, k_hi):
        """(leaf, its stitched keys, in-slice mask) for each leaf of the run
        of ``[k_lo, k_hi)``."""
        k_lo, k_hi = np.uint64(k_lo), np.uint64(k_hi)
        for leaf in self._slice_run(k_lo, k_hi):
            lk = self.image.leaf_keys(leaf)
            yield leaf, lk, (lk >= k_lo) & (lk < k_hi)

    def count_slice(self, k_lo, k_hi) -> int:
        """Stitched live keys in ``[k_lo, k_hi)`` (no flush)."""
        return sum(int(m.sum()) for _, _, m in self._slice_rows(k_lo, k_hi))

    def snapshot_slice(self, k_lo, k_hi) -> Tuple[np.ndarray, np.ndarray]:
        """Live pairs in ``[k_lo, k_hi)`` as ascending ``(keys, vals)`` —
        the copy half of a slice migration.  Flushes staged writes first."""
        self.flush()
        ks, vs = [], []
        for leaf, lk, m in self._slice_rows(k_lo, k_hi):
            if m.any():
                ks.append(lk[m].copy())
                vs.append(self.image.leaf_vals(leaf)[m].copy())
        if not ks:
            empty = np.zeros(0, dtype=np.uint64)
            return empty, empty.copy()
        return np.concatenate(ks), np.concatenate(vs)

    def extract_slice(self, k_lo, k_hi) -> Tuple[np.ndarray, np.ndarray]:
        """Detach the live pairs in ``[k_lo, k_hi)``: returns them and
        removes them from this store through one flush cycle of synthesized
        tombstones.  A fully emptied leaf stays in the chain as an empty
        routing stub (``compact_chain`` removes it)."""
        keys, vals = self.snapshot_slice(k_lo, k_hi)  # flushes
        if keys.size:
            pending = [
                (leaf, [(int(k), 0, IB_DEL) for k in lk[m]])
                for leaf, lk, m in self._slice_rows(k_lo, k_hi)
                if m.any()
            ]
            self._run_patch_cycle(pending)
        self.stats.migrated_out_keys += int(keys.size)
        return keys, vals

    def stub_count(self) -> int:
        """Empty routing-stub leaves currently in the chain."""
        return sum(int(self.image.leaf_count[leaf]) == 0 for leaf in self._chain())

    def compact_chain(self) -> int:
        """Remove empty leaf stubs from the chain (and their parent entries)
        as one stitch transaction.  The chain head is kept, stubs with
        buffered writes are skipped, and under retention a stub whose
        retained versions still hold keys stays.  Returns the number of
        stubs removed."""
        ib_counts = self._ib_counts()
        stubs = []
        prev = -1
        for leaf in self._chain():
            if (
                int(self.image.leaf_count[leaf]) == 0
                and int(ib_counts[leaf]) == 0
                and prev != -1
                and self._stub_version_safe(leaf)
            ):
                stubs.append(leaf)
            else:
                prev = leaf
        if not stubs:
            return 0
        batch, n = patch.plan_chain_compaction(self.image, stubs)
        if n == 0:
            return 0
        self._apply_batch(batch)
        self.stats.stub_leaves_compacted += n
        return n

    def _stub_version_safe(self, leaf: int) -> bool:
        """Retention gate for chain compaction: every version of the stub
        back to the oldest retained epoch must be empty, else an ``as_of``
        read could lose keys that only the stub's chain still serves."""
        if self.epochs.retain <= 0:
            return True
        oldest = self.epochs.horizon + 1  # oldest retained version epoch
        vb, vp = self.image.ver_birth, self.image.ver_prev
        lc = self.image.leaf_count
        node = int(leaf)
        while True:
            if int(lc[node]) != 0:
                return False
            if int(vb[node]) <= oldest:
                return True
            prev = int(vp[node])
            if prev < 0:
                return True
            node = prev

    # ------------------------------------------------------------ TTL sweep
    def ttl_sweep(self) -> int:
        """Physically reclaim expired keys: tombstone every key past its
        deadline, flush, then compact the chain.  ``as_of`` windows still
        see the keys until their epochs age out.  Returns the number of
        keys reclaimed."""
        expired = self.ttl.expired_keys()
        if not expired:
            return 0
        keys = np.array(sorted(expired), dtype=np.uint64)
        self.delete(keys)  # note_delete drops the deadlines
        self.flush()
        self.compact_chain()
        return int(keys.size)

    def ingest_headroom(self) -> int:
        """Keys :meth:`ingest_slice` can absorb without risking pool
        exhaustion (new leaves fill at ``split_cap``; half the free pool
        stays reserved)."""
        free = min(len(self.image.free_leaves), len(self.image.free_slots))
        return max(0, (free // 2) * self.cfg.split_cap)

    def ingest_slice(self, keys_u64, vals_u64, wave: int = 512, splice: bool = True) -> int:
        """Bulk-ingest pairs (the receiving half of a slice migration).

        The default is a direct leaf-run splice: the pairs are sorted (the
        last of duplicate keys wins), grouped by target leaf and planned
        straight through the batched patch pipeline as synthesized PUT
        entries, each touched leaf once per cycle.  ``splice=False`` is the
        chunked-PUT path through the insert buffers.  Both leave the slice
        stitched on return and raise ``MemoryError`` on pool pressure
        rather than dropping keys."""
        keys = np.asarray(keys_u64, dtype=np.uint64)
        vals = np.asarray(vals_u64, dtype=np.uint64)
        if not splice:
            for i in range(0, keys.size, wave):
                st = self.put(keys[i : i + wave], vals[i : i + wave])
                if not np.all(st == STATUS_OK):
                    raise MemoryError(
                        f"ingest_slice: {int((st != STATUS_OK).sum())} keys "
                        "failed to land (pool pressure) — raise "
                        "TreeConfig.growth or shrink the migration"
                    )
            self.flush()
            self.stats.migrated_in_keys += int(keys.size)
            return int(keys.size)
        n_in = int(keys.size)
        self.flush()  # staged ops stitch first; ingest entries then win
        if keys.size:
            order = np.argsort(keys, kind="stable")
            sk, sv = keys[order], vals[order]
            last = np.ones(sk.size, dtype=bool)
            last[:-1] = sk[1:] != sk[:-1]  # duplicate key: last PUT wins
            sk, sv = sk[last], sv[last]
            pos = 0
            cfg = self.cfg
            while pos < sk.size:
                # one splice cycle: consecutive leaf groups until the pool
                # budget (half the free leaf/slot rows) is spent
                budget = min(len(self.image.free_leaves), len(self.image.free_slots)) // 2
                if budget < 2 or not self._headroom_ok(0):
                    raise MemoryError(
                        "ingest_slice: leaf pools exhausted mid-splice — "
                        "raise TreeConfig.growth or shrink the migration"
                    )
                pending = []
                while pos < sk.size and budget >= 2:
                    leaf, _ = self.image.find_leaf(sk[pos])
                    # group end by TREE routing (bisect for the last key
                    # still routed to ``leaf``; find_leaf is monotone)
                    lo, hi = pos + 1, sk.size
                    while lo < hi:
                        mid = (lo + hi) // 2
                        if int(self.image.find_leaf(sk[mid])[0]) == int(leaf):
                            lo = mid + 1
                        else:
                            hi = mid
                    take = lo - pos
                    have = int(self.image.leaf_count[leaf])
                    need = -(-(have + take) // cfg.split_cap) + 1
                    if need > budget:
                        # partial group: only what this cycle's budget
                        # absorbs (two items for one leaf cannot share a cycle)
                        take = min(take, (budget - 1) * cfg.split_cap - have)
                        if take <= 0:
                            break
                        need = budget
                    chunk = [
                        (int(k), int(v), IB_PUT)
                        for k, v in zip(sk[pos : pos + take], sv[pos : pos + take])
                    ]
                    pending.append((int(leaf), chunk))
                    pos += take
                    budget -= need
                if not pending:
                    raise MemoryError(
                        "ingest_slice: leaf pools exhausted mid-splice — "
                        "raise TreeConfig.growth or shrink the migration"
                    )
                self._run_patch_cycle(pending)
        self.stats.migrated_in_keys += n_in
        return n_in

    # ------------------------------------------------------------- analysis
    def memory_report(self) -> Dict[str, float]:
        """Table-1 style accounting: index overhead vs raw KV bytes."""
        idx = self.image.index_bytes()
        data = self.image.data_bytes()
        return {
            "index_bytes": idx,
            "data_bytes": data,
            "rel_overhead": idx / max(data, 1),
            "nic_bytes_total": idx + data,
            "dpa_resident_bytes": idx,
        }

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        """All live pairs in key order (stitched tree + buffered writes),
        expired TTL keys left out."""
        base = {}
        for k, v in self.image.iter_items():
            base[int(k)] = int(v)
        counts = self._ib_counts()
        leaves = np.where(counts > 0)[0]
        if leaves.size:
            idx = torch.from_numpy(leaves).to(self.device)
            ops_ = self.ib.op[idx].cpu().numpy()
            ibk = join_u64(self.ib.keys[idx].cpu().numpy())
            ibv = join_u64(self.ib.vals[idx].cpu().numpy())
            for r, leaf in enumerate(leaves):
                for j in range(int(counts[leaf])):
                    k = int(ibk[r, j])
                    if ops_[r, j] == IB_PUT:
                        base[k] = int(ibv[r, j])
                    elif ops_[r, j] == IB_DEL:
                        base.pop(k, None)
        if self.ttl:
            now, dl = self.ttl.now, self.ttl.deadlines
            base = {k: v for k, v in base.items() if k not in dl or now < dl[k]}
        ks = np.array(sorted(base.keys()), dtype=np.uint64)
        vs = np.array([base[int(k)] for k in ks], dtype=np.uint64)
        return ks, vs
