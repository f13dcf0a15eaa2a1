"""Serving engine of the port: the multi-tenant wave scheduler
(``KVWaveDriver``) of the JAX package's ``serving/engine.py``, and
``PagedAttentionLayer``, one attention layer served through the
learned-index paged KV cache.  ``Engine`` and ``ServeConfig`` (dense-cache
batched prefill and decode) are still to port.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import keys as keymod
from ..core.api import RangeResult
from ..models.layers import decode_attention
from .admission import ADMIT_OK, ADMIT_RETRY, AdmissionController
from .paged_cache import PagedCache


@dataclass
class TenantReply:
    """One completed client request, demultiplexed back out of its waves.

    ``status`` is :data:`~repro_torch.serving.admission.ADMIT_OK` with the
    op-specific ``result`` (GET: ``(vals, found)``; PUT/DELETE: i32 status
    per key; RANGE: a :class:`~repro_torch.core.api.RangeResult` whose keys are
    decoded back to the tenant's local key space), or
    :data:`~repro_torch.serving.admission.ADMIT_RETRY` with ``result=None`` when
    admission refused the request — re-submit after the tenant's bucket
    refills; the refusal consumed no tokens and mutated nothing."""

    ticket: int
    tenant: object
    op: str
    status: str
    result: object


class _Request:
    """Internal per-request record: encoded key rows + result staging."""

    __slots__ = (
        "ticket", "tenant", "op", "keys", "vals", "limit", "k_max",
        "n", "taken", "done", "arrived",
        "r_vals", "r_found", "r_status", "r_keys", "r_rvals", "r_counts",
    )

    def __init__(self, ticket, tenant, op, keys, vals, limit, k_max, arrived):
        self.ticket = ticket
        self.tenant = tenant
        self.op = op
        self.keys = keys
        self.vals = vals
        self.limit = limit
        self.k_max = k_max
        self.n = keys.size
        self.taken = 0  # rows already packed into sealed waves
        self.done = 0  # rows whose results have landed
        self.arrived = arrived
        if op == "get":
            self.r_vals = np.zeros(self.n, dtype=np.uint64)
            self.r_found = np.zeros(self.n, dtype=bool)
        elif op in ("put", "delete"):
            self.r_status = np.zeros(self.n, dtype=np.int32)
        else:  # range
            self.r_keys = np.zeros((self.n, max(limit, 0)), dtype=np.uint64)
            self.r_rvals = np.zeros((self.n, max(limit, 0)), dtype=np.uint64)
            self.r_counts = np.zeros(self.n, dtype=np.int64)


class _Wave:
    __slots__ = ("kind", "ticket", "segments")

    def __init__(self, kind, ticket, segments):
        self.kind = kind
        self.ticket = ticket  # pipeline WaveTicket
        self.segments = segments  # [(request, request_row_offset, n_rows)]


class KVWaveDriver:
    """Multi-tenant batch-forming front end for the KV service: the
    host-side analogue of the paper's DPA ingestion loop, where steering
    threads accumulate arriving requests into the next wave while prior
    waves drain through the thread grid.

    **Wave formation.**  Client requests (``get``/``put``/``delete``/
    ``range``) land in per-tenant forming queues inside an op-homogeneous
    forming group.  A wave seals — and dispatches asynchronously through
    :class:`repro_torch.serving.pipeline.PipelinedStore` — when

    * the group reaches ``wave_size`` rows (oversized client batches are
      **chunked** across consecutive full waves, so no wave ever exceeds
      the budget the pipeline's queue-depth accounting assumes),
    * the **deadline** fires: :meth:`tick` advances the logical clock, and
      a group whose oldest request has waited ``max_delay`` ticks seals
      without needing further arrivals,
    * the op kind (or RANGE limit) changes — preserving the client's
      cross-op ordering through the pipeline's ordered delivery,
    * or :meth:`drain` harvests the tail.

    Mixed-tenant waves are packed **fairly**: sealing takes rows from the
    tenant queues in proportion to their admission weights (deficit-style
    weighted shares, FIFO within a tenant), so a bursty tenant cannot
    starve another's slots in the wave it shares.

    **Tenant namespaces.**  With ``tenant_bits`` set, request keys are
    tenant-local: the scheduler packs the tenant id into the top bits
    (:func:`repro_torch.core.keys.encode_tenant` — exact limb arithmetic), every
    RANGE row is clipped at the tenant's namespace ceiling via the store's
    per-row ``k_max`` (:func:`repro_torch.core.keys.tenant_ceil`), and results
    are decoded back to local keys on delivery — so GET/PUT/DELETE/RANGE,
    boundary routing, rebalancing and resharding all operate on one
    ordered key space with no tenant awareness below this layer.

    **Admission.**  An optional :class:`~repro_torch.serving.admission.
    AdmissionController` gates every request: over-budget requests get an
    explicit :data:`ADMIT_RETRY` reply (never a silent drop, and never a
    partial batch); the refusal consumes no tokens, so re-submission after
    a refill is lossless.

    **Tickets.**  :meth:`request` returns a monotonically increasing
    ticket id that stays valid across :meth:`drain` calls; ``drain()``
    reports each completed request as a :class:`TenantReply` carrying its
    ticket."""

    def __init__(
        self,
        store,
        queue_depth: int = 2,
        wave_size: int = 512,
        max_delay: int = 8,
        admission: Optional[AdmissionController] = None,
        tenant_bits: Optional[int] = None,
        max_leaves: int = 4,
    ):
        from .pipeline import PipelinedStore

        assert wave_size >= 1, f"wave_size must be >= 1, got {wave_size}"
        assert max_delay >= 1, f"max_delay must be >= 1, got {max_delay}"
        self.store = (
            store
            if isinstance(store, PipelinedStore)
            else PipelinedStore(store, queue_depth=queue_depth, name="kv-engine")
        )
        self.wave_size = wave_size
        self.max_delay = max_delay
        self.admission = admission
        self.tenant_bits = tenant_bits
        self.max_leaves = max_leaves
        self.clock = 0  # logical time: advanced only by tick()
        self._forming_key: Optional[Tuple[str, int]] = None  # (op, limit)
        self._queues: "OrderedDict[object, deque]" = OrderedDict()
        self._formed_rows = 0
        self._inflight: List[_Wave] = []
        self._replies: List[TenantReply] = []
        self._next_ticket = 1
        # observability
        self.waves_formed = 0
        self.seals = {"size": 0, "deadline": 0, "kind": 0, "drain": 0}
        self.rows_enqueued: Dict = {}
        self.rows_served: Dict = {}
        self.leaked_rows = 0  # live RANGE rows decoding to a foreign tenant

    # ------------------------------------------------------------ intake
    def _alloc_ticket(self) -> int:
        t = self._next_ticket
        self._next_ticket += 1
        return t

    def request(self, op: str, keys, vals=None, limit: int = 10, tenant=None):
        """Enqueue one client request; returns its (monotonic) ticket id.

        ``keys`` (and ``vals``) are tenant-local when the scheduler runs with
        ``tenant_bits``; ``tenant`` defaults to 0 in that mode and to the
        anonymous single tenant otherwise.  Raises ``ValueError`` on a
        malformed request (``put`` without ``vals``, length mismatch, keys
        outside the tenant namespace) — client errors fail loudly at
        request time instead of desyncing a half-formed wave."""
        if op not in ("get", "put", "delete", "range"):
            raise ValueError(f"unknown op {op!r}")
        keys = np.atleast_1d(np.asarray(keys, dtype=np.uint64))
        if op == "put":
            if vals is None:
                # fail here, not in a later seal's concatenate (or by
                # pairing vals with the wrong keys)
                raise ValueError(
                    "put requires vals (one u64 per key); got vals=None"
                )
            vals = np.atleast_1d(np.asarray(vals, dtype=np.uint64))
            if vals.size != keys.size:
                raise ValueError(
                    f"put keys/vals length mismatch: {keys.size} keys vs "
                    f"{vals.size} vals"
                )
        elif vals is not None:
            raise ValueError(f"{op} takes no vals")
        if self.tenant_bits is not None and tenant is None:
            tenant = 0
        ticket = self._alloc_ticket()
        if self.admission is not None and not self.admission.admit(
            tenant, int(keys.size), self.clock
        ):
            # explicit RETRY, never a silent drop: nothing was encoded,
            # enqueued or charged — re-submission after a refill is lossless
            self._replies.append(
                TenantReply(ticket, tenant, op, ADMIT_RETRY, None)
            )
            return ticket
        k_max = None
        if self.tenant_bits is not None:
            # composite encoding validates the namespace (raises on
            # overflow rather than leaking into a neighbour's slab)
            keys = keymod.encode_tenant(tenant, keys, self.tenant_bits)
            if op == "range":
                k_max = keymod.tenant_ceil(tenant, self.tenant_bits)
        if self._forming_key is not None and self._forming_key != (
            op,
            limit if op == "range" else 0,
        ):
            self._seal_all("kind")  # cross-op ordering rides wave order
        self._forming_key = (op, limit if op == "range" else 0)
        req = _Request(ticket, tenant, op, keys, vals, limit, k_max, self.clock)
        self._queues.setdefault(tenant, deque()).append(req)
        self._formed_rows += req.n
        self.rows_enqueued[tenant] = self.rows_enqueued.get(tenant, 0) + req.n
        if req.n == 0:  # degenerate batch: complete immediately
            self._queues[tenant].remove(req)
            self._finish(req)
            if self._formed_rows == 0 and not any(self._queues.values()):
                self._forming_key = None
            return ticket
        while self._formed_rows >= self.wave_size:
            self._seal_wave("size")
        return ticket

    def tick(self, n: int = 1) -> int:
        """Advance the logical clock by ``n`` ticks and fire any deadline
        seal: a forming group whose oldest request has waited
        ``max_delay`` ticks dispatches WITHOUT further arrivals — the
        batching-delay bound that keeps a quiet tenant's requests from
        waiting forever behind an unfilled wave.  Returns the number of
        waves sealed."""
        assert n >= 1, n
        self.clock += n
        sealed = 0
        if self._formed_rows and self.clock - self._oldest_arrival() >= self.max_delay:
            sealed = self._seal_all("deadline")
        return sealed

    def _oldest_arrival(self) -> int:
        return min(q[0].arrived for q in self._queues.values() if q)

    # ----------------------------------------------------------- sealing
    def _weight(self, tenant) -> float:
        if self.admission is not None:
            return self.admission.weight(tenant)
        return 1.0

    def _seal_all(self, reason: str) -> int:
        sealed = 0
        while self._formed_rows:
            self._seal_wave(reason)
            sealed += 1
        return sealed

    def _seal_wave(self, reason: str) -> None:
        """Form and dispatch ONE wave of up to ``wave_size`` rows, taking
        rows from the tenant queues in proportion to admission weights
        (FIFO within a tenant; a request bigger than the remaining budget
        is split — its tail stays queued for the next wave)."""
        if not self._formed_rows:
            return
        op, limit = self._forming_key
        cap = self.wave_size
        segments: List[Tuple[_Request, int, int]] = []
        while cap > 0 and self._formed_rows > 0:
            pending = [t for t, q in self._queues.items() if q]
            wsum = sum(self._weight(t) for t in pending)
            cap0 = cap
            for t in pending:
                if cap <= 0:
                    break
                q = self._queues[t]
                # this round's fair share of the remaining budget (>= 1 so
                # a tiny-weight tenant still progresses)
                share = max(1, int(cap0 * self._weight(t) / wsum))
                while share > 0 and cap > 0 and q:
                    req = q[0]
                    k = min(req.n - req.taken, share, cap)
                    segments.append((req, req.taken, k))
                    req.taken += k
                    share -= k
                    cap -= k
                    self._formed_rows -= k
                    if req.taken == req.n:
                        q.popleft()
        if not any(self._queues.values()):
            self._forming_key = None
        keys = np.concatenate([r.keys[o : o + k] for r, o, k in segments])
        if op == "get":
            t = self.store.submit_get(keys)
        elif op == "put":
            vals = np.concatenate([r.vals[o : o + k] for r, o, k in segments])
            t = self.store.submit_put(keys, vals)
        elif op == "delete":
            t = self.store.submit_delete(keys)
        else:
            k_max = None
            if any(r.k_max is not None for r, _, _ in segments):
                # per-row namespace ceiling: a mixed-tenant RANGE wave
                # clips each row at ITS tenant's slab end, so a scan can
                # never walk into the next tenant's namespace
                k_max = np.concatenate(
                    [
                        np.full(
                            k,
                            keymod.KEY_MAX if r.k_max is None else r.k_max,
                            dtype=np.uint64,
                        )
                        for r, _, k in segments
                    ]
                )
            t = self.store.submit_range(
                keys, limit, k_max=k_max, max_leaves=self.max_leaves
            )
        self._inflight.append(_Wave(op, t, segments))
        self.waves_formed += 1
        self.seals[reason] += 1

    # ------------------------------------------------------------ harvest
    def _finish(self, req: _Request) -> None:
        if req.op == "get":
            result = (req.r_vals, req.r_found)
        elif req.op in ("put", "delete"):
            result = req.r_status
        else:
            rkeys = req.r_keys
            if self.tenant_bits is not None and req.n:
                tids, local = keymod.decode_tenant(rkeys, self.tenant_bits)
                live = np.arange(max(req.limit, 0))[None, :] < req.r_counts[:, None]
                # defensive isolation accounting: with the per-row k_max
                # clip this is structurally 0 (the tests assert it)
                self.leaked_rows += int((live & (tids != req.tenant)).sum())
                rkeys = np.where(live, local, np.uint64(0))
            result = RangeResult(
                keys=rkeys, vals=req.r_rvals, counts=req.r_counts
            )
        self.rows_served[req.tenant] = (
            self.rows_served.get(req.tenant, 0) + req.n
        )
        self._replies.append(
            TenantReply(req.ticket, req.tenant, req.op, ADMIT_OK, result)
        )

    def _demux(self, wave: _Wave, res) -> None:
        off = 0
        for req, roff, k in wave.segments:
            rows = slice(off, off + k)
            dst = slice(roff, roff + k)
            if wave.kind == "get":
                vals, found = res
                req.r_vals[dst] = vals[rows]
                req.r_found[dst] = found[rows]
            elif wave.kind in ("put", "delete"):
                req.r_status[dst] = np.asarray(res)[rows]
            else:
                req.r_keys[dst] = res.keys[rows]
                req.r_rvals[dst] = res.vals[rows]
                req.r_counts[dst] = res.counts[rows]
            off += k
            req.done += k
            if req.done == req.n:
                self._finish(req)

    def drain(self) -> List[TenantReply]:
        """Seal everything still forming, complete every in-flight wave
        (submission order — the pipeline's ordered-delivery guarantee) and
        return one :class:`TenantReply` per finished request, in ticket
        order.  Admission-refused requests appear with ``status=ADMIT_
        RETRY``.  Ticket ids are NOT invalidated by the drain: they are
        allocated monotonically for the scheduler's lifetime."""
        self._seal_all("drain")
        for wave in self._inflight:
            self._demux(wave, self.store.result(wave.ticket))
        self._inflight.clear()
        out = sorted(self._replies, key=lambda r: r.ticket)
        self._replies = []
        return out

    # -------------------------------------------------------------- obs
    @property
    def inflight_waves(self) -> int:
        return len(self._inflight)

    def pipeline_summary(self) -> Dict:
        return self.store.pipeline_summary()

    def scheduler_summary(self) -> Dict:
        return {
            "waves": self.waves_formed,
            "seals": dict(self.seals),
            "rows_enqueued": dict(self.rows_enqueued),
            "rows_served": dict(self.rows_served),
            "leaked_rows": self.leaked_rows,
            "clock": self.clock,
            "admission": (
                self.admission.summary() if self.admission is not None else None
            ),
        }


class PagedAttentionLayer:
    """One attention layer served through the learned-index paged cache.

    Equivalent dense computation is ``decode_attention(q, K, V)``; the tests
    and ``chip_smoke.py`` hold the paged path against it."""

    def __init__(self, kv_heads: int, head_dim: int, block_size: int = 16, n_blocks: int = 512, device=None):
        self.cache = PagedCache(n_blocks, block_size, kv_heads, head_dim, device=device)
        self.kv_heads = kv_heads
        self.head_dim = head_dim

    def append(self, seq_id: int, k, v) -> None:
        self.cache.append(seq_id, k, v)

    def attend(self, seq_id: int, q: torch.Tensor) -> torch.Tensor:
        """q (H, hd) for the newest position -> (H, hd) output."""
        k, v, n = self.cache.gather(seq_id)
        q = torch.as_tensor(q, device=k.device)
        out = decode_attention(q[None, None], k[None], v[None], n)
        return out[0, 0]
