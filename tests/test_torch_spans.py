"""The port's host spans (``repro_torch.core.spans``) on the CPU: the table's
sums and call counts, the profiler gate, the names the store, the facade and
the pipeline record, the serial-write counter and the facade's totals."""

import numpy as np
import pytest
import torch

from repro_torch.core import DPAStore, TreeConfig
from repro_torch.core.spans import SpanTable, format_totals, label, recording, span, sum_totals
from repro_torch.distributed.kvshard import ShardedDPAStore
from repro_torch.serving.pipeline import PipelinedStore

pytestmark = pytest.mark.timeout(300)

KEY_BOUND = 2**63

GET_SPANS = ("kv/get/build", "kv/get/launch", "kv/get/copy")
WRITE_SPANS = ("kv/write/proof", "kv/write/fast", "kv/write/barrier", "kv/write/serial")
FLUSH_SPANS = ("kv/flush/plan", "kv/flush/apply")
RANGE_SPANS = ("kv/range/start", "kv/range/merge", "kv/range/copy", "kv/range/epilogue", "kv/range/admit")
BUILD_SPANS = ("kv/build/image", "kv/build/bulk_batch", "kv/build/to_device")
PHASES = ("kv/get/issue", "kv/get/drain", "kv/put/issue", "kv/put/drain", "kv/range/issue", "kv/range/drain")


def _keys(n=600, seed=5):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(1, KEY_BOUND, n, dtype=np.uint64))


def _store(keys, ib_cap=16):
    return DPAStore(keys, keys ^ np.uint64(0xA5), TreeConfig(ib_cap=ib_cap, growth=16.0), device="cpu")


def _drive(pipe, keys, rng, waves=4):
    """Every kind of wave: GETs, fast and serial PUTs (a run of fresh keys
    into one leaf fills its buffer), scans that truncate."""
    for w in range(waves):
        pipe.submit_get(rng.choice(keys, 32))
        pipe.submit_range(rng.choice(keys, 16), 8, max_leaves=1)
        fresh = rng.integers(1, KEY_BOUND, 8, dtype=np.uint64)
        pipe.submit_put(fresh, fresh)
        run = np.arange(keys[300] + 1, keys[300] + 1 + 24 + w, dtype=np.uint64)
        pipe.submit_put(run, run)
    pipe.drain()


def test_table_sums_calls_and_nesting():
    t = SpanTable()
    for _ in range(3):
        with span(t, "outer"):
            with span(t, "inner"):
                pass
            with span(t, "inner"):
                pass
    with span(t, "other"):
        pass
    assert t["outer"][1] == 3 and t["inner"][1] == 6 and t["other"][1] == 1
    assert t["outer"][0] >= t["inner"][0] > 0
    # an entry made for a hot site shows in the totals once it is called
    hot = t.entry("hot")
    assert t.entry("hot") is hot and set(t.totals()) == {"outer", "inner", "other"}
    hot[0] += 7
    hot[1] += 1
    assert t.totals()["hot"] == (7, 1)
    t.add("inner", 5, 2)
    assert t["inner"][1] == 8
    both = sum_totals([t.totals(), {"inner": (1, 1), "new": (2, 3)}])
    assert both["inner"] == (t["inner"][0] + 1, 9) and both["new"] == (2, 3)
    assert "inner" in format_totals(both)
    # a label with no profiler is nothing, and an exception still closes a span
    assert not recording()
    with label("label-only"):
        pass
    with pytest.raises(ValueError):
        with span(t, "raises"):
            raise ValueError
    assert t["raises"][1] == 1


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(label):
        entered.append(label)
        return real(label)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    keys = _keys()
    pipe = PipelinedStore(_store(keys), queue_depth=2)
    _drive(pipe, keys, np.random.default_rng(1), waves=2)
    assert entered == []
    assert pipe.span_totals()["kv/get/issue"][1] == 2
    # a wave in flight counts its issue, not yet its drain
    t = pipe.submit_get(keys[:4])
    assert pipe.span_totals()["kv/get/issue"][1] == 3 and pipe.span_totals()["kv/get/drain"][1] == 2
    pipe.result(t)
    assert pipe.span_totals()["kv/get/drain"][1] == 3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert recording()
        with span(SpanTable(), "kv/probe"):
            pass
        with label("kv/probe#1"):
            pass
    assert entered == ["kv/probe", "kv/probe#1"]


def test_every_span_name_lands_in_a_profiler_trace():
    keys = _keys()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        store = _store(keys)
        pipe = PipelinedStore(store, queue_depth=2)
        _drive(pipe, keys, np.random.default_rng(2))
        sharded = ShardedDPAStore(keys, keys, 2, TreeConfig(growth=16.0), device="cpu")
        sh = PipelinedStore(sharded, queue_depth=2)
        sh.result(sh.submit_get(keys[:40]))
        sh.result(sh.submit_put(keys[:8], keys[:8]))
    names = {e.key for e in prof.key_averages()}
    totals = sum_totals([pipe.span_totals(), sh.span_totals()])
    want = GET_SPANS + WRITE_SPANS + FLUSH_SPANS + RANGE_SPANS + BUILD_SPANS + ("kv/shard/route",)
    for name in want:
        assert name in totals, (name, sorted(totals))
        assert name in names, (name, sorted(n for n in names if n.startswith("kv/")))
    # the pipeline's phases keep their labels on the timeline, by sequence
    assert "kv/get/issue#0" in names and "kv/put/drain#3" in names
    for name in PHASES:
        assert name in totals
    # no new span ends like the phases the benchmark's trace attributes by
    for name in want:
        assert not name.endswith(("/issue", "/drain")), name


def test_serial_write_counter_equals_the_waves_that_fell_back():
    keys = _keys()
    store = _store(keys, ib_cap=8)
    fell_back = []
    real = store.write_issue

    def watching(op, k, v=None):
        w = real(op, k, v)
        fell_back.append(w is None)
        return w

    store.write_issue = watching
    pipe = PipelinedStore(store, queue_depth=2)
    rng = np.random.default_rng(3)
    for w in range(12):
        # two scattered keys land on the fast path until their buffers near
        # the cap; a run of ten fresh keys into one leaf cannot
        q = rng.choice(keys, 2) if w % 3 else np.arange(keys[w * 40] + 1, keys[w * 40] + 11, dtype=np.uint64)
        pipe.submit_put(q, q)
        pipe.submit_get(rng.choice(keys, 16))
    pipe.drain()
    spans = pipe.span_totals()
    assert 0 < sum(fell_back) < len(fell_back), fell_back
    assert spans["kv/write/serial"][1] == spans["kv/write/barrier"][1] == sum(fell_back)
    assert spans["kv/write/fast"][1] == len(fell_back) - sum(fell_back)
    assert spans["kv/write/proof"][1] == len(fell_back)
    assert spans["kv/put/issue"][1] == len(fell_back)
    # flush cycles run only on the serial path here
    assert spans["kv/flush/apply"][1] == store.stats.stitch_applies > 0
    assert spans["kv/flush/plan"][1] == store.stats.stitch_applies


@pytest.mark.parametrize("partition", ["hash", "range"])
def test_sharded_totals_are_the_shards_plus_routing(partition):
    keys = _keys(900, seed=7)
    store = ShardedDPAStore(keys, keys, 3, TreeConfig(growth=16.0), partition=partition, device="cpu")
    pipe = PipelinedStore(store, queue_depth=2)
    rng = np.random.default_rng(4)
    for _ in range(3):
        pipe.submit_get(rng.choice(keys, 40))
        pipe.submit_range(rng.choice(keys, 12), 6)
        q = rng.integers(1, KEY_BOUND, 10, dtype=np.uint64)
        pipe.submit_put(q, q)
    pipe.drain()
    store.put(keys[:5], keys[:5])
    got = store.span_totals()
    want = sum_totals([st.span_totals() for st in store.shards] + [{"kv/shard/route": tuple(store.spans["kv/shard/route"])}])
    assert got == want
    assert set(store.spans) == {"kv/shard/route"}
    # every GET and write wave routes, a serial fallback and the direct put
    # once more; a hash RANGE broadcasts without routing
    serial = pipe.span_totals().get("kv/write/serial", (0, 0))[1]
    assert got["kv/shard/route"][1] == 3 + 3 + serial + 1 + (3 if partition == "range" else 0)
    for name in BUILD_SPANS:
        assert got[name][1] == 3
    assert pipe.span_totals()["kv/get/issue"][1] == 3
