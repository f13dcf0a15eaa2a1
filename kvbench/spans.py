"""The program's host spans over one run of a cell, read by hand.

    python3 kvbench/spans.py --workload ycsb-b.50M-hash4 --seed 7 --seconds 20 --trace 1

Runs the cell exactly as ``run.py`` does (``harness.run_cell``) and prints,
as its last line, the run's result beside what the program's span tables
(``repro_torch/core/spans.py``: ``span_totals()`` of the pipeline, the store
and each shard) read over it:

* ``spans``: the store build's spans, and the measured window's with the
  profiled slice's part left out (``window``) and that part alone (``slice``);
* ``counts``: the reads, scans and writes behind them (``StoreStats``);
* ``per_layer``: the per-op readings of those spans (``read_spans``);
* with ``--trace 1``: ``idle_gaps_by_span``, the slice's device idle gaps put
  down to the innermost ``kv/`` span of any name and the host op under it,
  and ``inner_share``, the share of each wave phase's time on the slice's
  timeline that named inner spans cover;
* ``span_cost``: with no profiler, on this host, what one ``span``, one
  phase label and one flush cycle's timing cost (``unit_ns``), and what the
  window's spans cost by that reckoning per 65,536 operations and per wave
  of each kind.

The benchmark's own metrics do not read these spans: its harness would need
``rec["spans"]`` first.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import argparse  # noqa: E402
import json  # noqa: E402

from kvbench import harness, trace  # noqa: E402

PHASE_ENDS = ("/issue", "/drain")


def _spans(program) -> dict:
    return {k: list(v) for k, v in program.pipe.span_totals().items()}


def _shard_spans(program) -> list:
    shards = getattr(program.store, "shards", [])  # a single store has none
    return [{k: list(v) for k, v in st.span_totals().items()} for st in shards]


def _delta(x, y):
    """``x - y`` over nested dicts, lists and numbers; what ``y`` lacks
    counts as 0."""
    if isinstance(x, dict):
        return {k: _delta(v, (y or {}).get(k)) for k, v in x.items()}
    if isinstance(x, list):
        return [_delta(a, b) for a, b in zip(x, y or [None] * len(x))]
    return x - (y or 0)


class _Marks:
    """Snapshots of the span tables and counters at the run's boundaries,
    taken by wrapping ``harness.Program`` and ``trace.Slice`` for one run."""

    def __init__(self):
        self.at = {}
        self.events = None
        self.program = None

    def mark(self, name):
        p = self.program
        self.at[name] = {
            "spans": _spans(p),
            "shards": _shard_spans(p),
            "counters": dict(self._saved[0].counters(p)),
        }

    def __enter__(self):
        marks = self
        self._saved = (harness.Program, trace.Slice.start, trace.Slice.stop, trace.Slice.events)
        Program, start, stop, events = self._saved

        class Watched(Program):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                marks.program = self
                marks.mark("build")

            def counters(self):
                # the harness reads the counters once before the window, once after
                name = "after" if "before" in marks.at else "before"
                marks.mark(name)
                return dict(marks.at[name]["counters"])

        def s_start(sl):
            start(sl)
            marks.mark("slice0")

        def s_stop(sl):
            stop(sl)
            marks.mark("slice1")

        def s_events(sl):
            marks.events = events(sl)
            return marks.events

        harness.Program = Watched
        trace.Slice.start, trace.Slice.stop, trace.Slice.events = s_start, s_stop, s_events
        return self

    def __exit__(self, *exc):
        harness.Program, trace.Slice.start, trace.Slice.stop, trace.Slice.events = self._saved
        return False

    def window(self):
        """The window's deltas with the slice's part left out, and the
        slice's (None without a slice)."""
        whole = _delta(self.at["after"], self.at["before"])
        if "slice0" not in self.at:
            return whole, None
        part = _delta(self.at["slice1"], self.at["slice0"])
        return _delta(whole, part), part


def _called(spans: dict) -> dict:
    return {k: v for k, v in spans.items() if v[1]}


def read_spans(spans: dict, counts: dict, build: dict) -> dict:
    """The spans read per operation: the metrics a harness reading the span
    tables would report (None where a span or its denominator is absent)."""

    def ns(name):
        return spans.get(name, (0, 0))[0]

    def calls(name):
        return spans.get(name, (0, 0))[1]

    def per(num, den, scale):
        return num / scale / den if num and den else None

    reads, scans, writes = counts.get("gets", 0), counts.get("ranges", 0), counts.get("puts", 0)
    return {
        "get_launch_us_per_read": per(ns("kv/get/launch"), reads, 1e3),
        "write_proof_us_per_write": per(ns("kv/write/proof"), writes, 1e3),
        "serial_write_share": (
            100.0 * calls("kv/write/serial") / calls("kv/put/issue") if calls("kv/put/issue") else None
        ),
        "flush_plan_ms_per_cycle": per(ns("kv/flush/plan"), calls("kv/flush/plan"), 1e6),
        "stitch_apply_ms_per_cycle": per(ns("kv/flush/apply"), calls("kv/flush/apply"), 1e6),
        "route_us_per_op": per(ns("kv/shard/route"), reads + scans + writes, 1e3),
        "range_copy_us_per_scan": per(ns("kv/range/copy"), scans, 1e3),
        "range_epilogue_us_per_scan": per(ns("kv/range/epilogue"), scans, 1e3),
        "build_image_s": build["kv/build/image"][0] / 1e9 if "kv/build/image" in build else None,
        "build_to_device_s": build["kv/build/to_device"][0] / 1e9 if "kv/build/to_device" in build else None,
    }


def _kv_spans(events):
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name", "").startswith("kv/"):
            ts = float(e["ts"])
            out.append((ts, ts + float(e.get("dur", 0.0)), e["name"].split("#")[0]))
    out.sort()
    return out


def idle_gaps_by_span(events, top: int = 12):
    """The slice's device idle gaps by the innermost ``kv/`` span of any
    name around each gap's middle, and the host op there (as
    ``trace.summarize`` puts them down to the wave phases)."""
    sl = [e for e in events if e.get("ph") == "X" and e.get("name") == trace.SLICE]
    if not sl:
        return None
    s0 = float(sl[0]["ts"])
    s1 = s0 + float(sl[0]["dur"])
    tid = sl[0].get("tid")
    spans = _kv_spans(events)
    starts = [s[0] for s in spans]
    ops = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", ""))
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "cpu_op" and e.get("tid") == tid
    )
    op_starts = [o[0] for o in ops]
    runtime = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in trace.RUNTIME_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                runtime[c] = float(e["ts"])
    iv = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATS:
            a = float(e["ts"])
            if s0 <= runtime.get((e.get("args") or {}).get("correlation"), a) <= s1:
                iv.append((max(a, s0), min(a + float(e.get("dur", 0.0)), s1)))
    merged = trace._merge([x for x in iv if x[1] > x[0]])
    edges = [s0] + [x for ab in merged for x in ab] + [s1]
    gaps = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        m = (a + b) / 2
        sp = trace._innermost(spans, starts, m)
        op = trace._innermost(ops, op_starts, m)
        what = sp[2] if sp else "client"
        if op:
            what += ": " + op[2][:60]
        gaps[what] += (b - a) / 1e6
    return sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:top]


def inner_share(events) -> dict:
    """For each wave phase (``kv/<kind>/issue`` or ``.../drain``) on the
    slice's timeline: its seconds and the share of them that the named
    spans inside it cover."""
    spans = _kv_spans(events)
    total, covered = defaultdict(float), defaultdict(float)
    for i, (a, b, name) in enumerate(spans):
        if not name.endswith(PHASE_ENDS):
            continue
        inner = []
        for c, d, child in spans[i + 1 :]:
            if c > b:
                break
            if d <= b and not child.endswith(PHASE_ENDS):
                inner.append((c, d))
        total[name] += (b - a) / 1e6
        covered[name] += sum(d - c for c, d in trace._merge(inner)) / 1e6
    return {k: {"s": total[k], "inner": covered[k] / total[k] if total[k] else None} for k in total}


def _unit_costs(n: int = 200_000) -> dict:
    """Host ns, no profiler: one empty ``span``; one wave phase's label (the
    pipeline's, two a wave); what ``DPAStore._run_patch_cycle`` adds to a
    flush cycle (its profiler check, three clock reads, two entries, and
    the ``_plan_batch`` frame), as a replica of those lines."""
    from repro_torch.core.spans import SpanTable, clock, label, recording, span

    t = SpanTable()
    flush = (t.entry("kv/flush/plan"), t.entry("kv/flush/apply"))

    def each(body):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            body()
        return (time.perf_counter_ns() - t0) / n

    def one_span():
        with span(t, "kv/cost"):
            pass

    def one_label():
        with label("kv/get/issue#0"):
            pass

    def frame():
        return None

    def one_cycle():
        if recording():
            return
        t0 = clock()
        frame()
        t1 = clock()
        t2 = clock()
        plan_e, apply_e = flush
        plan_e[0] += t1 - t0
        plan_e[1] += 1
        apply_e[0] += t2 - t1
        apply_e[1] += 1

    empty = each(frame)
    return {"span": each(one_span) - empty, "label": each(one_label) - empty, "flush_cycle": each(one_cycle) - empty}


def span_cost(window: dict, counts: dict, unit: dict) -> dict:
    """What the window's spans cost with no profiler, reckoned from their
    calls and ``unit``: per 65,536 operations, and per wave of each kind
    (its own spans, two labels, and its share of the facade's routing)."""
    waves = {k.split("/")[1]: v[1] for k, v in window.items() if k.endswith("/issue")}
    n_waves = sum(waves.values())
    family = {"get": ("kv/get/",), "put": ("kv/write/", "kv/flush/"), "range": ("kv/range/",)}

    def cost(name, calls):
        if name.endswith(("/issue", "/drain")):
            return calls * unit["label"]
        if name == "kv/flush/apply":
            return 0.0  # counted with its plan, one flush cycle
        if name == "kv/flush/plan":
            return calls * unit["flush_cycle"]
        return calls * unit["span"]

    total = sum(cost(k, v[1]) for k, v in window.items() if not k.startswith("kv/build/"))
    route = cost("kv/shard/route", window.get("kv/shard/route", (0, 0))[1]) / n_waves if n_waves else 0.0
    per_wave = {}
    for kind, n in waves.items():
        own = sum(
            cost(k, v[1]) for k, v in window.items()
            if k.startswith(family.get(kind, (f"kv/{kind}/",))) and not k.endswith(("/issue", "/drain"))
        )
        per_wave[kind] = (own / n + 2 * unit["label"] + route) / 1e3
    ops = sum(counts.get(k, 0) for k in ("gets", "ranges", "puts", "deletes"))
    return {"unit_ns": unit, "us_per_65536_ops": total / 1e3 * 65536 / ops if ops else None, "us_per_wave": per_wave}


def run(cell: str, seed: int, seconds: float, traced: bool, **kw) -> dict:
    with _Marks() as m:
        out = harness.run_cell(cell, seed, seconds, traced, **kw)
    window, part = m.window()
    keep = ("gets", "ranges", "puts", "deletes", "flush_cycles", "waves")
    counts = window["counters"]
    build = m.at["build"]["spans"]
    rec = {
        "workload": cell,
        "seed": seed,
        "result": out,
        "spans": {
            "build": build,
            "window": _called(window["spans"]),
            "slice": None if part is None else _called(part["spans"]),
        },
        "shard_spans": [_called(t) for t in window["shards"]],
        "counts": {"window": {k: counts.get(k, 0) for k in keep}},
        "per_layer": read_spans(window["spans"], counts, build),
        "span_cost": span_cost(_called(window["spans"]), counts, _unit_costs()),
    }
    if part is not None:
        rec["counts"]["slice"] = {k: part["counters"].get(k, 0) for k in keep}
    if m.events is not None:
        rec["idle_gaps_by_span"] = idle_gaps_by_span(m.events)
        rec["inner_share"] = inner_share(m.events)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kvbench.spans: no CUDA device", file=sys.stderr)
        return 2
    rec = run(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda",
              log=lambda s: print(s, flush=True))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
