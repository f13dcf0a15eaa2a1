"""``kvbench/spans.py``, the hand-run reader of the program's span tables,
on each cell at the CPU size: what it reads where, that it leaves the
harness as it found it, and what it reckons the spans cost."""

import pytest

from kvbench import harness, spans, trace
from kvbench.tests.conftest import CELLS, TINY

SEED = 2**35 + 29

# the readings each cell must give a number for; None in the others
WHERE = {
    "get_launch_us_per_read": {"ycsb-c.50M", "ycsb-b.50M-hash4"},
    "write_proof_us_per_write": {"ycsb-b.50M-hash4", "ycsb-e.50M"},
    "serial_write_share": {"ycsb-b.50M-hash4", "ycsb-e.50M"},
    "route_us_per_op": {"ycsb-b.50M-hash4"},
    "range_copy_us_per_scan": {"ycsb-e.50M"},
    "range_epilogue_us_per_scan": {"ycsb-e.50M"},
    "build_image_s": set(CELLS),
    "build_to_device_s": set(CELLS),
}


def _run(cell, traced=True):
    return spans.run(cell, SEED, 0.6, traced, device="cpu", overrides=TINY, log=lambda s: None)


@pytest.mark.parametrize("cell", CELLS)
def test_each_reading_where_its_cell_has_it(cell):
    program, start, stop, events = harness.Program, trace.Slice.start, trace.Slice.stop, trace.Slice.events
    rec = _run(cell)
    assert (harness.Program, trace.Slice.start, trace.Slice.stop, trace.Slice.events) == (program, start, stop, events)
    assert rec["result"]["correct"] is True
    got = rec["per_layer"]
    for name, cells in WHERE.items():
        assert (got[name] is not None) == (cell in cells), (name, got[name])
    for name in ("flush_plan_ms_per_cycle", "stitch_apply_ms_per_cycle"):
        assert (got[name] is not None) == (rec["counts"]["window"]["flush_cycles"] > 0), name
    window = rec["spans"]["window"]
    assert window and all(ns >= 0 and calls > 0 for ns, calls in window.values())
    if rec["spans"]["slice"] is not None:
        assert rec["idle_gaps_by_span"] and rec["inner_share"]
    assert len(rec["shard_spans"]) == (4 if cell == "ycsb-b.50M-hash4" else 0)
    cost = rec["span_cost"]
    assert all(v > 0 for v in cost["unit_ns"].values()) and cost["us_per_65536_ops"] > 0
    kinds = {k.split("/")[1] for k in window if k.endswith("/issue")}
    assert set(cost["us_per_wave"]) == kinds and all(v > 0 for v in cost["us_per_wave"].values())


def test_gaps_go_to_the_innermost_span_of_any_name():
    slice_ = {"ph": "X", "cat": "user_annotation", "name": trace.SLICE, "ts": 0, "dur": 100, "tid": 1}
    phase = {"ph": "X", "cat": "user_annotation", "name": "kv/range/drain#3", "ts": 10, "dur": 80, "tid": 1}
    inner = {"ph": "X", "cat": "user_annotation", "name": "kv/range/epilogue", "ts": 40, "dur": 40, "tid": 1}
    op = {"ph": "X", "cat": "cpu_op", "name": "aten::where", "ts": 45, "dur": 30, "tid": 1}
    kern = {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 20, "args": {"correlation": 9}}
    launch = {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 1, "args": {"correlation": 9}}
    events = [slice_, phase, inner, op, kern, launch]
    gaps = dict(spans.idle_gaps_by_span(events))
    # one gap, 20..100 us, whose middle (60) lies in the epilogue's op
    assert gaps == {"kv/range/epilogue: aten::where": pytest.approx(80e-6)}
    share = spans.inner_share(events)
    assert share == {"kv/range/drain": {"s": pytest.approx(80e-6), "inner": pytest.approx(0.5)}}
