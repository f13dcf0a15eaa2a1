"""Bounded-depth wave pipeline: issue wave N+1 while wave N drains — the
PyTorch port of the JAX package's ``serving/pipeline.py``.

The paper's DPA ingestion loop never idles: steering threads pull the next
request batch while earlier waves drain through the traverser grid.  A
:class:`WavePipeline` keeps up to ``queue_depth`` waves in flight.  Each
wave's *issue* phase (host build + kernel launches, which CUDA queues on
the stream) runs while earlier waves are still in flight, and the *drain*
phase (the blocking copy to the host + host epilogue) runs in submission
order, so results are delivered exactly as the serial facade would.
``queue_depth=2`` is the double buffer.

Correctness contract (what makes pipelined == serial bitwise):

* **Reads pipeline freely.**  GET/RANGE issue launches work against the
  tree and the insert buffers; the hot cache and the scan-anchor cache are
  correctness-invariant (a hit returns exactly what the tree path would),
  so their contents may differ between pipelined and serial runs without
  any output bit changing.
* **Writes pipeline on the fast path only.**  A write wave is issued
  asynchronously only when the host-side buffer shadow proves it cannot
  fill any insert buffer to ``ib_cap`` (``DPAStore._write_plan``).
  Otherwise the pipeline **drains before the stitch cycle** and the batch
  takes the unmodified serial path, so patches happen at the same points
  of the op stream as in serial execution and the leaf layout (and with it
  every RANGE continuation cursor) stays bitwise identical.
* **Epoch flips are barriers.**  ``flush``, slice migration, snapshots,
  sweeps and every method in :data:`_BARRIER_METHODS` drain the pipeline
  first: an in-flight wave was admitted under the old epoch and completes
  under it.
* **Wave contexts own their tensors.**  The port's store updates its
  insert buffers, caches and pools in place, on one CUDA stream.  A wave
  context therefore holds only tensors the wave itself produced, never a
  view of store state: a view would let wave N's finalize read what wave
  N+1's issue wrote.  ``tests/test_torch_pipeline.py`` pins this.

Observability: every wave is timed into a :class:`WaveLedger`
(``wave_issue_ns`` / ``wave_drain_ns`` per wave plus in-flight intervals).
While a profiler records, each phase is labelled ``<name>/<kind>/issue#<seq>``
or ``.../drain#<seq>`` on its timeline (``core/spans.py``), around the
store's own spans; :meth:`WavePipeline.span_totals` gives the ledger's
phase times as spans, and :meth:`PipelinedStore.span_totals` adds the
store's.  :meth:`WavePipeline.trace` records a Chrome trace.
``core.perfmodel.pipelined_wave_mops`` turns the ledger into a host
roofline.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core import api
from ..core.spans import SpanTable, label, span, sum_totals


# ---------------------------------------------------------------------------
# timing ledger
# ---------------------------------------------------------------------------


@dataclass
class WaveRecord:
    seq: int
    kind: str
    t_issue0: int  # ns, issue phase start (host build begins)
    t_issue1: int  # ns, issue phase end (launches queued)
    t_drain0: int = 0  # ns, drain phase start (blocking copy begins)
    t_drain1: int = 0  # ns, drain phase end (results on host)

    @property
    def issue_ns(self) -> int:
        return self.t_issue1 - self.t_issue0

    @property
    def drain_ns(self) -> int:
        return self.t_drain1 - self.t_drain0

    @property
    def inflight(self) -> Tuple[int, int]:
        """The wave's in-flight interval: issue start -> drain end."""
        return (self.t_issue0, self.t_drain1)


@dataclass
class WaveLedger:
    """Per-wave timing ledger."""

    records: List[WaveRecord] = field(default_factory=list)

    @property
    def n_waves(self) -> int:
        return len(self.records)

    @property
    def wave_issue_ns(self) -> int:
        return sum(r.issue_ns for r in self.records)

    @property
    def wave_drain_ns(self) -> int:
        return sum(r.drain_ns for r in self.records)

    def summary(self) -> dict:
        n = max(self.n_waves, 1)
        return {
            "waves": self.n_waves,
            "wave_issue_ns": self.wave_issue_ns,
            "wave_drain_ns": self.wave_drain_ns,
            "issue_us_per_wave": self.wave_issue_ns / n / 1e3,
            "drain_us_per_wave": self.wave_drain_ns / n / 1e3,
        }


# ---------------------------------------------------------------------------
# the pipeline core
# ---------------------------------------------------------------------------


class WaveTicket:
    """Handle for one submitted wave; redeem with ``WavePipeline.result``."""

    __slots__ = ("seq", "kind", "ctx", "finalize_fn", "record", "_result", "_done")

    def __init__(self, seq, kind, ctx, finalize_fn, record):
        self.seq = seq
        self.kind = kind
        self.ctx = ctx
        self.finalize_fn = finalize_fn
        self.record = record
        self._result = None
        self._done = False


class WavePipeline:
    """Bounded-depth wave dispatcher with ordered result delivery.

    ``submit(issue_fn, finalize_fn)`` runs ``issue_fn()`` immediately (host
    build + kernel launches; its return value is the wave context) and
    returns a :class:`WaveTicket`.  At most ``queue_depth`` waves stay in
    flight: submitting past the bound first drains the oldest wave.
    ``result(ticket)`` drains every earlier wave first, so results complete
    strictly in submission order.  ``drain()`` is the barrier the store
    facade calls before any stitch cycle or epoch flip.  ``device`` is the
    store's device: :meth:`trace` records CUDA activity when it is a card."""

    def __init__(self, queue_depth: int = 2, name: str = "waves", device=None):
        assert queue_depth >= 1, f"queue_depth must be >= 1, got {queue_depth}"
        self.queue_depth = queue_depth
        self.name = name
        self.device = None if device is None else torch.device(device)
        self.ledger = WaveLedger()
        self.last_trace = None  # the profiler of the last trace() context
        self._inflight: deque[WaveTicket] = deque()
        self._seq = 0

    # ------------------------------------------------------------- submit
    def submit(
        self,
        issue_fn: Callable[[], Any],
        finalize_fn: Callable[[Any], Any],
        kind: str = "op",
    ) -> WaveTicket:
        while len(self._inflight) >= self.queue_depth:
            self._drain_oldest()
        seq = self._seq
        self._seq += 1
        t0 = time.perf_counter_ns()
        with label(f"{self.name}/{kind}/issue#{seq}"):
            ctx = issue_fn()
        t1 = time.perf_counter_ns()
        rec = WaveRecord(seq=seq, kind=kind, t_issue0=t0, t_issue1=t1)
        ticket = WaveTicket(seq, kind, ctx, finalize_fn, rec)
        self._inflight.append(ticket)
        return ticket

    # -------------------------------------------------------------- drain
    def _drain_oldest(self) -> None:
        ticket = self._inflight.popleft()
        ticket.record.t_drain0 = time.perf_counter_ns()
        with label(f"{self.name}/{ticket.kind}/drain#{ticket.seq}"):
            ticket._result = ticket.finalize_fn(ticket.ctx)
        ticket.record.t_drain1 = time.perf_counter_ns()
        ticket.ctx = None  # drop the wave's tensors once its result is on the host
        ticket._done = True
        self.ledger.records.append(ticket.record)

    def result(self, ticket: WaveTicket):
        """Block until ``ticket``'s wave (and every wave submitted before
        it — ordered delivery) has drained; returns its result."""
        while not ticket._done:
            assert self._inflight and self._inflight[0].seq <= ticket.seq, (
                "ticket is neither drained nor in flight — was it submitted "
                "to this pipeline?"
            )
            self._drain_oldest()
        return ticket._result

    def drain(self) -> None:
        """The epoch barrier: complete every in-flight wave."""
        while self._inflight:
            self._drain_oldest()

    def span_totals(self) -> dict:
        """The waves' phases as spans, ``<name>/<kind>/issue`` and
        ``.../drain`` -> (ns, calls): the ledger's drained waves, and the
        issue of those still in flight."""
        t = SpanTable()
        for r in self.ledger.records:
            t.add(f"{self.name}/{r.kind}/issue", r.issue_ns)
            t.add(f"{self.name}/{r.kind}/drain", r.drain_ns)
        for tk in self._inflight:
            t.add(f"{self.name}/{tk.kind}/issue", tk.record.issue_ns)
        return t.totals()

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    # ---------------------------------------------------------- profiling
    @contextlib.contextmanager
    def trace(self, log_dir: str):
        """Record everything run inside the context with ``torch.profiler``
        (the wave spans included): CPU activity, and CUDA activity when the
        pipeline's device is a card.  On exit the device is synchronised,
        the trace is written to ``log_dir/<name>.pt.trace.json`` and the
        profiler is kept in ``last_trace``.  A profiler failure raises."""
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device is not None and self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield self
            if cuda:
                torch.cuda.synchronize(self.device)
        self.last_trace = prof
        prof.export_chrome_trace(os.path.join(log_dir, f"{self.name}.pt.trace.json"))


# ---------------------------------------------------------------------------
# ping-pong wave buffer pool
# ---------------------------------------------------------------------------


class WaveBufferPool:
    """Reusable host staging buffers for wave builds, with in-flight
    pinning: ``acquire`` hands out a free buffer set (allocating on demand
    up to ``depth + 1``), and a buffer can only be reused after ``release``,
    which the pipeline calls at drain time.  At queue_depth=2 the pool
    alternates between two buffer sets; the pinning makes reusing a buffer
    an in-flight wave still references structurally impossible."""

    def __init__(self, make: Callable[[], Any], depth: int = 2):
        self._make = make
        self._cap = depth + 1
        self._free: List[Any] = []
        self._pinned: List[Any] = []

    def acquire(self):
        if self._free:
            buf = self._free.pop()
        else:
            assert len(self._pinned) < self._cap, (
                "wave buffer pool exhausted: a wave was issued without "
                "draining — pipeline depth and pool depth disagree"
            )
            buf = self._make()
        self._pinned.append(buf)
        return buf

    def release(self, buf) -> None:
        self._pinned.remove(buf)
        self._free.append(buf)

    @property
    def pinned(self) -> int:
        return len(self._pinned)


# ---------------------------------------------------------------------------
# the pipelined store facade
# ---------------------------------------------------------------------------

#: store methods that must not run while waves are in flight: each one
#: either starts a stitch cycle, flips an ownership epoch, or reads host
#: state (leaf chains, pool free lists) that an in-flight wave's deferred
#: epilogue could still move.  The facade drains the pipeline first.  The
#: set keeps the reference's names, the sharded tiers' included.
_BARRIER_METHODS = frozenset(
    {
        "flush",
        "begin_rebalance",
        "commit_rebalance",
        "rebalance",
        "maybe_rebalance",
        "kill_replica",
        "retire_failover",
        "recover_replicas",
        "begin_reshard",
        "commit_reshard",
        "reshard",
        "evacuate_shard",
        "maybe_evacuate",
        "compact_chain",
        "maybe_compact",
        "snapshot_epoch",
        "ttl_sweep",
        "snapshot_slice",
        "extract_slice",
        "ingest_slice",
        "items",
        "live_count",
        "count_slice",
        "stub_count",
        "shard_occupancy",
        "occupancy_spread",
        "memory_report",
        "stats_totals",
        "stacked",
    }
)


class PipelinedStore:
    """Drop-in ``KVStore`` facade that drives a wrapped
    :class:`~repro_torch.core.store.DPAStore` through a :class:`WavePipeline`.

    * **async** — ``submit_get/submit_put/submit_delete/submit_range``
      return tickets; redeem with :meth:`result`.  Up to ``queue_depth``
      waves are in flight, results come back in submission order, bitwise
      identical to running the same batches serially.
    * **sync** — ``get/put/delete/range`` submit and immediately redeem.

    Barrier methods (``flush``, slice migration, ``items`` ...) drain the
    pipeline before running."""

    def __init__(self, store, queue_depth: int = 2, name: str = "kv"):
        self.store = store
        self.pipeline = WavePipeline(queue_depth, name=name, device=getattr(store, "device", None))
        self.spans = SpanTable()  # write barriers and serial write waves
        self.queue_depth = queue_depth

    # -------------------------------------------------------------- async
    def submit_get(
        self,
        keys,
        *,
        epoch: Optional[int] = None,
        as_of: Optional[int] = None,
    ) -> WaveTicket:
        keys = np.asarray(keys, dtype=np.uint64)
        if as_of is not None:
            # versioned reads are barriers: the per-epoch resolve table is
            # built from host chain state an in-flight write wave's stitch
            # could still move.  Drain, then read serially inside the issue
            self.pipeline.drain()
            return self.pipeline.submit(
                lambda: self.store.get(keys, as_of=as_of),
                lambda r: r,
                kind="get_as_of",
            )
        return self.pipeline.submit(
            lambda: self.store.get_issue(keys, epoch=epoch),
            self.store.get_finalize,
            kind="get",
        )

    def _submit_write(self, op: str, keys, vals) -> WaveTicket:
        keys = np.asarray(keys, dtype=np.uint64)
        vals = None if vals is None else np.asarray(vals, dtype=np.uint64)

        def issue():
            w = self.store.write_issue(op, keys, vals)
            if w is not None:
                return ("fast", w)
            # a buffer could fill: this wave needs a stitch cycle, so the
            # pipeline drains first and the batch takes the serial path,
            # landing its patches at the serial op-stream points
            with span(self.spans, "kv/write/barrier"):
                self.pipeline.drain()
            with span(self.spans, "kv/write/serial"):
                if op == "put":
                    return ("serial", self.store.put(keys, vals))
                return ("serial", self.store.delete(keys))

        def finalize(ctx):
            mode, payload = ctx
            if mode == "serial":
                return payload
            return self.store.write_finalize(payload)

        return self.pipeline.submit(issue, finalize, kind=op)

    def submit_put(self, keys, vals) -> WaveTicket:
        return self._submit_write("put", keys, vals)

    def submit_delete(self, keys) -> WaveTicket:
        return self._submit_write("delete", keys, None)

    def submit_range(
        self,
        k_min,
        limit: int = 10,
        *,
        k_max=None,
        epoch: Optional[int] = None,
        as_of: Optional[int] = None,
        max_leaves: int = 4,
    ) -> WaveTicket:
        k_min = np.asarray(k_min, dtype=np.uint64)
        if as_of is not None:
            # same barrier as submit_get
            self.pipeline.drain()
            return self.pipeline.submit(
                lambda: self.store.range(k_min, limit, k_max=k_max, max_leaves=max_leaves, as_of=as_of),
                lambda r: r,
                kind="range_as_of",
            )
        return self.pipeline.submit(
            lambda: self.store.range_issue(k_min, limit=limit, k_max=k_max, epoch=epoch, max_leaves=max_leaves),
            self.store.range_finalize,
            kind="range",
        )

    def result(self, ticket: WaveTicket):
        out = self.pipeline.result(ticket)
        self._sync_stats()
        return out

    def drain(self) -> None:
        self.pipeline.drain()
        self._sync_stats()

    def _sync_stats(self) -> None:
        """Fold the ledger's sums into the wrapped store's StoreStats."""
        st = getattr(self.store, "stats", None)
        if st is not None and hasattr(st, "wave_issue_ns"):
            st.wave_issue_ns = self.ledger.wave_issue_ns
            st.wave_drain_ns = self.ledger.wave_drain_ns

    # --------------------------------------------------------------- sync
    def get(self, keys=None, *, epoch: Optional[int] = None, as_of: Optional[int] = None, **legacy):
        keys = api.take_legacy("get", legacy, keys, "keys", "keys_u64")
        api.reject_unknown("get", legacy)
        return self.result(self.submit_get(keys, epoch=epoch, as_of=as_of))

    def put(self, keys=None, vals=None, *, auto_retry: bool = True, ttl: Optional[int] = None, **legacy):
        keys = api.take_legacy("put", legacy, keys, "keys", "keys_u64")
        vals = api.take_legacy("put", legacy, vals, "vals", "vals_u64")
        api.reject_unknown("put", legacy)
        if ttl is not None:
            # deadline bookkeeping rides the serial write path (the fast
            # path's write_issue clears deadlines, as a ttl=None write does)
            self.drain()
            return self.store.put(keys, vals, auto_retry=auto_retry, ttl=ttl)
        if not auto_retry:  # single-wave semantics need the serial path
            self.drain()
            return self.store.put(keys, vals, auto_retry=False)
        return self.result(self.submit_put(keys, vals))

    insert = put
    update = put

    def delete(self, keys=None, *, auto_retry: bool = True, **legacy):
        keys = api.take_legacy("delete", legacy, keys, "keys", "keys_u64")
        api.reject_unknown("delete", legacy)
        if not auto_retry:
            self.drain()
            return self.store.delete(keys, auto_retry=False)
        return self.result(self.submit_delete(keys))

    def range(
        self,
        k_min=None,
        limit: int = 10,
        *,
        k_max=None,
        epoch: Optional[int] = None,
        as_of: Optional[int] = None,
        max_leaves: int = 4,
        **legacy,
    ):
        k_min = api.take_legacy("range", legacy, k_min, "k_min", "start_keys_u64")
        api.reject_unknown("range", legacy)
        return self.result(
            self.submit_range(k_min, limit, k_max=k_max, epoch=epoch, as_of=as_of, max_leaves=max_leaves)
        )

    # -------------------------------------------------- barriered passthru
    def __getattr__(self, name):
        target = getattr(self.store, name)  # AttributeError propagates
        if name in _BARRIER_METHODS:

            def barriered(*args, **kw):
                self.pipeline.drain()
                return target(*args, **kw)

            return barriered
        return target

    # --------------------------------------------------------------- obs
    @property
    def ledger(self) -> WaveLedger:
        return self.pipeline.ledger

    def pipeline_summary(self) -> dict:
        return self.ledger.summary()

    def span_totals(self) -> dict:
        """``name -> (ns, calls)``: the store's spans, this front end's
        (write barriers, serial write waves) and the pipeline's wave phases.
        No barrier: in-flight waves' drains are not counted yet."""
        return sum_totals([self.store.span_totals(), self.spans.totals(), self.pipeline.span_totals()])
