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

Unlike the JAX store, which calls the jnp functions directly, this store
dispatches GET, both cache probes and the RANGE walk through
``repro_torch.kernels.ops``: on CUDA tensors the hand-written kernels run,
on CPU tensors their plain versions.  The state lives on ``device``, which
defaults to the card; the CPU is used only when asked for.  Insert buffers,
caches and pools are updated in place.

Outside this slice (they raise ``NotImplementedError``): point-in-time
reads (``as_of``, ``retain_epochs``) and TTL writes (``ttl=``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import api, hotcache, insert_buffer, lookup, patch, scancache, stitch
from .api import RangeResult
from .epoch import EpochManager
from .hotcache import CacheConfig, CacheState
from .keys import KEY_MAX, join_u64, limbs_to_tensor, split_u64
from .lookup import IB_DEL, IB_PUT, InsertBuffers
from .scancache import ScanCacheConfig, ScanCacheState
from .tree import SEG_CAP, TreeConfig, TreeImage, build_image
from ..kernels import ops

STATUS_OK = insert_buffer.STATUS_OK
STATUS_RETRY = insert_buffer.STATUS_RETRY


def resolve_device(device) -> torch.device:
    """``None`` means the card.  A CUDA device without CUDA raises: the
    store never moves to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "DPAStore runs on the CUDA device by default and none is available; "
            "pass device='cpu' to run the plain-torch path"
        )
    return dev


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
    # kept for field parity with the JAX store (paths outside this slice)
    stub_leaves_compacted: int = 0
    migrated_out_keys: int = 0
    migrated_in_keys: int = 0
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


@dataclass
class _RangeWave:
    """In-flight RANGE wave: device outputs of the range loop plus the
    pre-sized host accumulators the finalize phase fills."""

    n: int
    limit: int
    arity: int
    resumed: bool  # start_leaves was given (host-orchestrated re-issue)
    keys_out: np.ndarray
    vals_out: np.ndarray
    counts: np.ndarray
    trunc_out: np.ndarray
    cur_leaf_out: np.ndarray
    cur_key_out: np.ndarray
    rk: object = None
    rv: object = None
    valid: object = None
    trunc: object = None
    cursor: object = None
    rounds: int = 0
    empty: bool = False  # limit<=0 / n==0 short-circuit: no device wave


def _not_in_slice(what: str):
    return NotImplementedError(f"{what} is not ported to the PyTorch store yet")


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
        if retain_epochs:
            raise _not_in_slice("retain_epochs (point-in-time reads)")
        self.batched_patch = batched_patch
        keys = np.asarray(keys, dtype=np.uint64)
        vals = np.asarray(vals, dtype=np.uint64)
        if not np.all(keys < KEY_MAX):
            raise ValueError("2^64-1 is a reserved sentinel")
        self.cfg = tree_cfg
        self.image: TreeImage = build_image(keys, vals, tree_cfg)
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
        self.epochs = EpochManager(grace=epoch_grace, retain=0)
        self.epochs.on_defer = self._note_deferred_free

    # ------------------------------------------------------------------ util
    @property
    def depth(self) -> int:
        return self.image.depth

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
        exists for signature parity with the sharded tiers (only ``None``)."""
        keys = api.take_legacy("get", legacy, keys, "keys", "keys_u64")
        api.reject_unknown("get", legacy)
        return self.get_finalize(self.get_issue(keys, epoch=epoch, as_of=as_of))

    def get_issue(self, keys, *, epoch: Optional[int] = None, as_of: Optional[int] = None) -> _GetWave:
        """Issue half of GET: cache probe, GET kernel, cache admit — returns
        without blocking on device results."""
        if epoch is not None:
            raise ValueError("single-store GET has no routing epochs (epoch must be None)")
        if as_of is not None:
            raise _not_in_slice("as_of")
        keys_u64 = np.asarray(keys, dtype=np.uint64)
        n = keys_u64.size
        khi, klo = self._limbs(keys_u64)
        use_cache = self.cache is not None
        if use_cache:
            tid = self._steer(khi, klo)
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
        self._end_wave()
        return _GetWave(n=n, vhi=out_vhi, vlo=out_vlo, found=out_found, hits=hits)

    def get_finalize(self, w: _GetWave) -> Tuple[np.ndarray, np.ndarray]:
        """Drain half of GET: blocking gather + host epilogue."""
        if w.hits is not None:
            self.stats.cache_hits += int(w.hits.sum())
        vals = join_u64(torch.stack([w.vhi, w.vlo], dim=-1).cpu().numpy())
        found = w.found.cpu().numpy()
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

    def _write_wave(self, keys_u64, vals_u64, op_code: int) -> np.ndarray:
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
        return status.cpu().numpy()

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
        classifies the patch)."""
        keys = api.take_legacy("put", legacy, keys, "keys", "keys_u64")
        vals = api.take_legacy("put", legacy, vals, "vals", "vals_u64")
        api.reject_unknown("put", legacy)
        if ttl is not None:
            raise _not_in_slice("ttl")
        if args:  # legacy positional auto_retry
            api.warn_legacy("put", "positional auto_retry", "auto_retry=...")
            (auto_retry,) = args
        st = self._write(keys, vals, IB_PUT, auto_retry)
        self.stats.puts += np.asarray(keys, dtype=np.uint64).size
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
        self.stats.deletes += np.asarray(keys, dtype=np.uint64).size
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
        their cursor until every row hit ``limit`` or exhausted the chain."""
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
        cursors back, -1 = fresh descent)."""
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
    ) -> _RangeWave:
        """Issue half of RANGE: anchor-cache start resolution + the range
        loop (kernel walk, merge epilogue, continuation rounds)."""
        if max_rounds is not None and max_rounds < 1:
            raise ValueError(
                "max_rounds: None = loop until limit/exhaustion/window; a "
                "bound must be >= 1 (0 would silently alias the unbounded loop)"
            )
        if epoch is not None:
            raise ValueError("single-store RANGE has no routing epochs (epoch must be None)")
        if as_of is not None:
            raise _not_in_slice("as_of")
        start_keys_u64 = np.asarray(k_min, dtype=np.uint64)
        n = start_keys_u64.size
        lim = max(limit, 0)
        w = _RangeWave(
            n=n,
            limit=limit,
            arity=arity,
            resumed=start_leaves is not None,
            keys_out=np.zeros((n, lim), dtype=np.uint64),
            vals_out=np.zeros((n, lim), dtype=np.uint64),
            counts=np.zeros(n, dtype=np.int64),
            trunc_out=np.zeros(n, dtype=bool),
            cur_leaf_out=np.full(n, -1, dtype=np.int32),
            cur_key_out=start_keys_u64.copy(),
        )
        self.stats.ranges += n
        if n == 0 or limit <= 0:
            w.empty = True
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
        start = self._scan_start(khi, klo, resume)
        w.rk, w.rv, w.valid, w.trunc, w.cursor, w.rounds = ops.range_scan_loop(
            self.tree,
            self.ib,
            khi,
            klo,
            depth=self.depth,
            eps_inner=self.cfg.eps_inner,
            limit=limit,
            max_leaves=max_leaves,
            max_rounds=0 if max_rounds is None else max_rounds,
            start_leaf=start,
            ub_hi=ub_hi,
            ub_lo=ub_lo,
        )
        self._end_wave()
        return w

    def range_finalize(self, w: _RangeWave) -> RangeResult:
        """Drain half of RANGE: gather, truncation epilogue and pagination
        cursor admission."""
        n, limit = w.n, w.limit
        keys_out, vals_out = w.keys_out, w.vals_out
        counts, trunc_out = w.counts, w.trunc_out
        cur_leaf_out, cur_key_out = w.cur_leaf_out, w.cur_key_out
        if w.empty:
            return RangeResult(
                keys=keys_out, vals=vals_out, counts=counts,
                truncated=trunc_out, cursor_leaf=cur_leaf_out,
                cursor_key=cur_key_out, rounds=0, stats={}, _arity=w.arity,
            )
        self.stats.range_rounds_in_mesh += max(w.rounds - 1, 0)
        va = w.valid.cpu().numpy()
        rc = va.sum(axis=1)
        keys_out[:] = np.where(va, join_u64(w.rk.cpu().numpy()), 0)
        vals_out[:] = np.where(va, join_u64(w.rv.cpu().numpy()), 0)
        counts[:] = rc
        trunc_out[:] = w.trunc.cpu().numpy()
        cur_leaf_out[:] = w.cursor.leaf.cpu().numpy()
        last_key = join_u64(torch.stack([w.cursor.khi, w.cursor.klo], dim=-1).cpu().numpy())
        emitted = rc > 0
        cur_key_out[emitted] = last_key[emitted]
        trunc_out &= counts < limit
        self.stats.range_truncated += int(trunc_out.sum())
        if not w.resumed:
            # only fresh client-entry scans admit their cursors: a resumed
            # call is an orchestration round whose cursors nobody probes
            self._admit_cursor_anchors(trunc_out, cur_key_out)
        return RangeResult(
            keys=keys_out,
            vals=vals_out,
            counts=counts,
            truncated=trunc_out,
            cursor_leaf=cur_leaf_out,
            cursor_key=cur_key_out,
            rounds=w.rounds,
            stats={"rounds_in_mesh": max(w.rounds - 1, 0), "reissue": int(w.resumed)},
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

    def _run_patch_cycle(self, pending) -> int:
        n_leaves = len(pending)
        self.stats.flush_cycles += 1
        if not self.batched_patch:
            for leaf, entries in pending:
                self._patch_leaf_entries(leaf, entries)
            return n_leaves
        while pending:
            chunk_leaves = [l for l, _ in pending]
            chunk_entries = [e for _, e in pending]
            self.image.version_cycle = self.epochs.cycle + 1
            result = patch.plan_patch_batch(
                self.image, chunk_leaves, chunk_entries,
                headroom_ok=self._headroom_ok,
                force_structural=False,
            )
            pending = result.unplanned
            # COPY then CONNECT — the stitch atomicity contract
            self.tree = stitch.apply_copies(self.tree, result.batch)
            self.tree, self.ib = stitch.apply_connects(self.tree, self.ib, result.batch)
            self.stats.stitch_applies += 1
            # cycle-granularity epoch bookkeeping; the on_defer listener
            # collects the obsoleted leaves whose anchors are dropped here
            self.epochs.defer_free_batch(result.batch.frees)
            self._apply_scan_invalidation()
            self.stats.reclaimed += self.epochs.end_cycle(self.image)
            self.stats.stitched_bytes += result.batch.payload_bytes()
            self.stats.stitched_dpa_bytes += result.batch.dpa_bytes()
            self.stats.patches_update += result.n_update
            self.stats.patches_structural += result.n_structural
            self.stats.new_leaves += len(result.new_leaves)
            self.stats.patched_leaves += len(result.results)
        return n_leaves

    def _patch_leaf_entries(self, leaf: int, entries) -> None:
        """Per-leaf oracle path: one stitch transaction per patched leaf."""
        self.image.version_cycle = self.epochs.cycle + 1
        result = patch.plan_patch(self.image, leaf, entries, force_structural=False)
        self.tree = stitch.apply_copies(self.tree, result.batch)
        self.tree, self.ib = stitch.apply_connects(self.tree, self.ib, result.batch)
        self.stats.stitch_applies += 1
        self.stats.patched_leaves += 1
        for pool, idx in result.batch.frees:
            self.epochs.defer_free(pool, idx)
        self._apply_scan_invalidation()
        self.stats.reclaimed += self.epochs.end_cycle(self.image)
        self.stats.stitched_bytes += result.batch.payload_bytes()
        self.stats.stitched_dpa_bytes += result.batch.dpa_bytes()
        if result.kind == "update":
            self.stats.patches_update += 1
        else:
            self.stats.patches_structural += 1
            self.stats.new_leaves += len(result.new_leaves)

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
        """All live pairs in key order (stitched tree + buffered writes)."""
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
        ks = np.array(sorted(base.keys()), dtype=np.uint64)
        vs = np.array([base[int(k)] for k in ks], dtype=np.uint64)
        return ks, vs
