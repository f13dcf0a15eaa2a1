"""The port's wave pipeline: ``PipelinedStore`` over the port's ``DPAStore``
(``device="cpu"``, the kernels' plain versions) == the JAX ``DPAStore`` run
serially, bitwise, on the single-store streams of ``tests/test_pipeline.py``.

Each stream runs three times: serially on a JAX store (the oracle),
pipelined on a JAX store (whose ledger the port's must match wave for wave)
and pipelined on the port's store with genuine submit lag (tickets redeemed
at the end, so up to ``queue_depth`` waves are in flight and every barrier
lands between in-flight waves).  Every output, ``items()``,
``flush_cycles``, ``puts`` and ``gets`` must be equal.  The pipeline's
mechanics (ordered delivery, the in-flight bound, the ledger, barriers, the
buffer pool) are held as the reference's tests hold them.  The JAX tests'
donation checks have no torch meaning: the port's store updates its state
in place, so instead no live wave context may share storage with it."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.serving.pipeline as jpipeline
from repro.core import DPAStore as JaxStore
from repro.core import TreeConfig as JaxTreeConfig
from repro.core.hotcache import CacheConfig as JaxCacheConfig
from repro_torch.core import CacheConfig, DPAStore, TreeConfig
from repro_torch.serving import pipeline
from repro_torch.serving.pipeline import PipelinedStore, WaveBufferPool, WavePipeline, WaveTicket

pytestmark = pytest.mark.timeout(300)

KEY_BOUND = 2**63


def _pair(keys, vals, cache=False):
    """(JAX store, port store) of the same keys, as tests/test_pipeline.py
    builds its single tier."""
    j = JaxStore(keys, vals, JaxTreeConfig(growth=16.0), cache_cfg=JaxCacheConfig() if cache else None)
    t = DPAStore(keys, vals, TreeConfig(growth=16.0), cache_cfg=CacheConfig() if cache else None, device="cpu")
    return j, t


def _gen_script(rng, n_ops, wave=24):
    """The single-tier op stream of tests/test_pipeline.py: GET, PUT,
    DELETE, RANGE (limits 1/7/40, 1 or 4 leaves a round) and flush."""
    mix = ["get", "put", "delete", "range", "flush"]
    script = []
    for _ in range(n_ops):
        op = mix[rng.integers(len(mix))]
        q = rng.integers(1, KEY_BOUND, wave, dtype=np.uint64)
        if op == "get":
            script.append(("get", q))
        elif op == "put":
            k = np.unique(q)
            script.append(("put", k, k ^ np.uint64(0xF)))
        elif op == "delete":
            script.append(("delete", np.unique(q[: wave // 2])))
        elif op == "range":
            script.append(("range", q[: wave // 2], int(rng.choice([1, 7, 40])), int(rng.choice([1, 4]))))
        else:
            script.append(("flush",))
    return script


def _norm(res):
    """Outputs as numpy arrays (a RangeResult through its legacy tuple)."""
    if res is None or isinstance(res, (bool, int)):
        return res
    if isinstance(res, np.ndarray):
        return res
    return tuple(np.asarray(x) for x in res)


def _assert_eq(ra, rb, ctx):
    if isinstance(ra, tuple):
        assert isinstance(rb, tuple) and len(ra) == len(rb), ctx
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(x, y, err_msg=str(ctx))
    elif isinstance(ra, np.ndarray):
        np.testing.assert_array_equal(ra, rb, err_msg=str(ctx))
    else:
        assert ra == rb, (ctx, ra, rb)


def _run_serial(store, script):
    out = []
    for op in script:
        if op[0] == "get":
            out.append(_norm(store.get(op[1])))
        elif op[0] == "put":
            out.append(_norm(store.put(op[1], op[2])))
        elif op[0] == "delete":
            out.append(_norm(store.delete(op[1])))
        elif op[0] == "range":
            out.append(_norm(store.range(op[1], limit=op[2], max_leaves=op[3])))
        else:
            out.append(_norm(store.flush()))
    return out


def _run_pipelined(pipe, script, on_submit=None):
    """Replay the stream with submit lag: tickets are redeemed only at the
    end, so up to ``queue_depth`` waves really overlap and every flush lands
    between in-flight waves.  ``on_submit(pipe)`` runs after each submit."""
    out = [None] * len(script)
    tickets = []
    for idx, op in enumerate(script):
        if op[0] == "get":
            tickets.append((idx, pipe.submit_get(op[1])))
        elif op[0] == "put":
            tickets.append((idx, pipe.submit_put(op[1], op[2])))
        elif op[0] == "delete":
            tickets.append((idx, pipe.submit_delete(op[1])))
        elif op[0] == "range":
            tickets.append((idx, pipe.submit_range(op[1], op[2], max_leaves=op[3])))
        else:
            out[idx] = _norm(pipe.flush())
        if on_submit is not None:
            on_submit(pipe)
    for idx, t in tickets:
        out[idx] = _norm(pipe.result(t))
    return out


def _differential(keys, vals, script, qd, cache=False, on_submit=None):
    """JAX serial == port pipelined, output by output; the port's ledger ==
    the JAX pipeline's, wave for wave.  Returns (JAX store, port store)."""
    j_serial, port = _pair(keys, vals, cache)
    j_piped = _pair(keys, vals, cache)[0]
    want = _run_serial(j_serial, script)
    jpipe = jpipeline.PipelinedStore(j_piped, queue_depth=qd)
    _run_pipelined(jpipe, script)
    pipe = PipelinedStore(port, queue_depth=qd)
    got = _run_pipelined(pipe, script, on_submit)
    for i, (ra, rb) in enumerate(zip(want, got)):
        _assert_eq(ra, rb, (qd, i, script[i][0]))
    ka, va = j_serial.items()
    kb, vb = pipe.items()  # barriered: drains first
    np.testing.assert_array_equal(kb, np.asarray(ka))
    np.testing.assert_array_equal(vb, np.asarray(va))
    assert port.stats.flush_cycles == j_serial.stats.flush_cycles
    assert port.stats.puts == j_serial.stats.puts and port.stats.gets == j_serial.stats.gets
    assert [(r.seq, r.kind) for r in pipe.ledger.records] == [(r.seq, r.kind) for r in jpipe.ledger.records]
    return j_serial, port


def _episode(qd, seed, n_ops=10, cache=False, on_submit=None):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, KEY_BOUND, 260, dtype=np.uint64))
    vals = keys ^ np.uint64(0xD1FF)
    script = _gen_script(rng, n_ops)
    return _differential(keys, vals, script, qd, cache, on_submit)


# ---------------------------------------------------------------------------
# pipelined port == serial reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("qd", [1, 2, 4])
def test_pipelined_port_equals_serial_reference(qd, cache):
    _episode(qd, seed=1000 * qd + 17 + cache, cache=cache)


def test_truncated_range_cursors_pipeline_equivalence():
    """Scans forced past one leaf a round (max_leaves=1, limit 40) drive the
    continuation loop under pipelined dispatch."""
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(1, KEY_BOUND, 400, dtype=np.uint64))
    vals = keys ^ np.uint64(0xC0)
    script = [("range", rng.choice(keys, 12), 40, 1) for _ in range(5)]
    script.insert(2, ("put", keys[:40], vals[:40]))
    j, port = _differential(keys, vals, script, 4)
    assert port.stats.range_rounds_in_mesh == j.stats.range_rounds_in_mesh > 0


def test_write_fallback_takes_serial_path_bitwise():
    """A wave the host shadow proves could fill an insert buffer drains the
    pipeline and takes the serial path: patches land at the same op-stream
    points (same flush_cycles, same leaf layout, same results)."""
    rng = np.random.default_rng(3)
    keys = np.sort(rng.choice(np.arange(1, 10**6, dtype=np.uint64), 300, replace=False))
    vals = keys ^ np.uint64(0x9)
    base = int(keys[len(keys) // 2])
    script = []
    for i in range(4):  # each wave of 24 sequential keys overflows ib_cap=16
        nk = np.arange(base + 1 + 24 * i, base + 1 + 24 * (i + 1), dtype=np.uint64)
        script.append(("put", nk, nk ^ np.uint64(0x7)))
        script.append(("get", nk))
    j, port = _differential(keys, vals, script, 2)
    assert port.stats.flush_cycles == j.stats.flush_cycles > 0, "episode must trigger stitches"


@given(st.data())
@settings(max_examples=4, deadline=None)
def test_barrier_interleaving_fuzz(data):
    """Flushes placed anywhere between in-flight waves, qd in {2, 4}, with
    and without the hot cache."""
    qd = data.draw(st.sampled_from([2, 4]))
    cache = data.draw(st.booleans())
    seed = data.draw(st.integers(0, 2**32 - 1))
    _episode(qd, seed, n_ops=8, cache=cache)


# ---------------------------------------------------------------------------
# wave contexts own their tensors
# ---------------------------------------------------------------------------


def _storages(obj, out, seen):
    """Storage pointers of every tensor reachable from ``obj`` (tuples,
    lists, dicts, namedtuples and dataclasses)."""
    if id(obj) in seen or obj is None:
        return out
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        out.add(obj.untyped_storage().data_ptr())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _storages(getattr(obj, f.name), out, seen)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _storages(x, out, seen)
    elif isinstance(obj, dict):
        for x in obj.values():
            _storages(x, out, seen)
    return out


def _state_storages(store):
    out = set()
    for part in (store.tree, store.ib, store.cache, store.scan_cache):
        _storages(part, out, set())
    return out


def _shared_with_state(pipe):
    ctx = [t.ctx for t in pipe.pipeline._inflight]
    return _storages(ctx, set(), set()) & _state_storages(pipe.store)


def test_helper_sees_a_view_of_store_state():
    """The check below would catch a context that held a view of the pools,
    the insert buffers or a cache."""
    store, _ = _mini_store(cache=True)
    pipe = PipelinedStore(store, queue_depth=2)
    for view in (store.ib.count[:3], store.tree.hbm_keys[1:], store.cache.bval[0], store.scan_cache.bleaf):
        pipe.pipeline.submit(lambda v=view: ("ctx", [v]), lambda c: None)
        assert _shared_with_state(pipe)
        pipe.drain()
    assert not _shared_with_state(pipe)


def test_wave_contexts_hold_no_store_state():
    """A deep pipelined stream (qd=4, every op kind, stitches and the hot
    cache included): after every submit, no in-flight wave context shares
    storage with the store's pools, insert buffers or caches.  The store
    updates that state in place, so a shared tensor would let an earlier
    wave's finalize read what a later wave's issue wrote."""
    seen = []

    def check(pipe):
        seen.append(pipe.pipeline.inflight)
        assert not _shared_with_state(pipe), "a wave context holds store state"

    _episode(4, seed=41, n_ops=12, cache=True, on_submit=check)
    assert max(seen) == 4, "the stream must fill the pipeline"


# ---------------------------------------------------------------------------
# pipeline mechanics
# ---------------------------------------------------------------------------


def _mini_store(seed=5, n=200, cache=False):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, KEY_BOUND, n, dtype=np.uint64))
    cfg = CacheConfig() if cache else None
    return DPAStore(keys, keys, TreeConfig(growth=16.0), cache_cfg=cfg, device="cpu"), keys


def test_ordered_delivery_and_out_of_order_redeem():
    store, keys = _mini_store()
    pipe = PipelinedStore(store, queue_depth=4)
    rng = np.random.default_rng(0)
    qs = [rng.choice(keys, 16) for _ in range(3)]
    t0, t1, t2 = (pipe.submit_get(q) for q in qs)
    v2, f2 = pipe.result(t2)  # redeeming the last ticket drains 0 and 1 first
    assert t0._done and t1._done, "ordered delivery: earlier waves drain first"
    assert f2.all() and np.array_equal(v2, qs[2])
    v0, _ = pipe.result(t0)  # already drained: cached result
    assert np.array_equal(v0, qs[0])
    assert [r.seq for r in pipe.ledger.records] == [0, 1, 2]


def test_queue_depth_bounds_inflight():
    store, keys = _mini_store()
    pipe = PipelinedStore(store, queue_depth=2)
    rng = np.random.default_rng(1)
    for _ in range(6):
        pipe.submit_get(rng.choice(keys, 8))
        assert pipe.pipeline.inflight <= 2
    pipe.drain()
    assert pipe.pipeline.inflight == 0
    assert pipe.ledger.n_waves == 6


@pytest.mark.parametrize("qd", [1, 2])
def test_overlap_ledger_and_stats_sync(qd):
    """qd=1 scores exactly 0 overlap; qd=2 with back-to-back submits scores
    > 0 by construction.  The ledger's sums land in StoreStats."""
    store, keys = _mini_store()
    pipe = PipelinedStore(store, queue_depth=qd)
    rng = np.random.default_rng(2)
    tickets = [pipe.submit_get(rng.choice(keys, 64)) for _ in range(6)]
    for t in tickets:
        pipe.result(t)
    s = pipe.pipeline_summary()
    assert s["waves"] == 6
    assert s["wave_issue_ns"] > 0 and s["wave_drain_ns"] >= 0
    assert (s["overlap_frac"] > 0.0) == (qd == 2), s
    assert store.stats.wave_issue_ns == s["wave_issue_ns"]
    assert store.stats.wave_drain_ns == s["wave_drain_ns"]


def test_barrier_methods_drain_first():
    store, keys = _mini_store()
    pipe = PipelinedStore(store, queue_depth=4)
    rng = np.random.default_rng(3)
    nk = np.unique(rng.integers(1, KEY_BOUND, 16, dtype=np.uint64))
    pipe.submit_put(nk, nk)
    pipe.submit_get(nk)
    assert pipe.pipeline.inflight == 2
    pipe.flush()  # barrier: drains before stitching
    assert pipe.pipeline.inflight == 0
    pipe.submit_get(nk)
    ks, _ = pipe.items()  # also barriered
    assert pipe.pipeline.inflight == 0 and np.isin(nk, ks).all()
    pipe.submit_get(nk)
    assert pipe.stats is store.stats and pipe.pipeline.inflight == 1  # a plain attribute is no barrier
    assert pipe.live_count() == store.live_count() and pipe.pipeline.inflight == 0


def test_wave_buffer_pool_pins_inflight_buffers():
    made = []

    def make():
        made.append(len(made))
        return {"id": len(made) - 1}

    pool = WaveBufferPool(make, depth=2)
    a = pool.acquire()
    b = pool.acquire()
    assert a is not b and pool.pinned == 2
    pool.release(a)
    c = pool.acquire()
    assert c is a, "released buffer is reused (ping-pong)"
    d = pool.acquire()  # 3rd concurrent = depth+1: allowed, pool grows
    assert pool.pinned == 3 and len(made) == 3
    with pytest.raises(AssertionError, match="exhausted"):
        pool.acquire()  # 4th concurrent: a wave was issued without draining
    del b, d


def test_pipeline_rejects_bad_depth_and_foreign_ticket():
    with pytest.raises(AssertionError):
        WavePipeline(0)
    p1 = WavePipeline(2)
    t = p1.submit(lambda: 1, lambda c: c + 1)
    assert p1.result(t) == 2
    p1.drain()
    assert p1.result(t) == 2  # drained tickets stay redeemable
    rogue = WaveTicket(9, "x", None, lambda c: c, t.record)
    with pytest.raises(AssertionError, match="submitted"):
        p1.result(rogue)


def test_wave_ctx_released_after_drain():
    store, keys = _mini_store(seed=13)
    pipe = PipelinedStore(store, queue_depth=2)
    t = pipe.submit_get(keys[:8])
    assert t.ctx is not None
    pipe.result(t)
    assert t.ctx is None


def test_trace_writes_a_chrome_trace_with_the_wave_spans(tmp_path):
    """``WavePipeline.trace`` records the waves' issue and drain spans with
    ``torch.profiler`` (CPU activity for a CPU store) and writes the trace."""
    store, keys = _mini_store()
    pipe = PipelinedStore(store, queue_depth=2)
    with pipe.pipeline.trace(str(tmp_path)):
        for _ in range(3):
            pipe.submit_get(keys[:8])
        pipe.drain()
    text = (tmp_path / "kv.pt.trace.json").read_text()
    for span in ("kv/get/issue#0", "kv/get/drain#2"):
        assert span in text
    names = {e.key for e in pipe.pipeline.last_trace.key_averages()}
    assert "kv/get/issue#1" in names


def test_every_public_name_of_the_reference_exists():
    """Every class and function the reference module defines, with its
    public methods, and the barrier set."""
    own = [
        (n, obj) for n, obj in vars(jpipeline).items()
        if (inspect.isclass(obj) or inspect.isfunction(obj)) and obj.__module__ == jpipeline.__name__
    ]
    assert len(own) >= 7
    for name, obj in own:
        mine = getattr(pipeline, name)
        if inspect.isclass(obj):
            for m in vars(obj):
                if not m.startswith("_") or m in ("__init__", "__getattr__"):
                    assert hasattr(mine, m), f"{name}.{m}"
    assert pipeline._BARRIER_METHODS == jpipeline._BARRIER_METHODS
