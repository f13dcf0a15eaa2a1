"""One run of one cell: set-up, the closed-loop window, the comparison with
the reference, and the metrics.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in ``BENCHMARK.json``: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py`` (a ``read(rec)``
that returns a number, or None where it finds nothing to read).

The client loop (closed, as ``launch/serve.py``'s ``serve_kv`` drives the
store): the stream is cut into groups of ``wave_size`` consecutive
operations; each group is split by kind into one wave per kind, submitted
in the order reads, scans, writes through ``PipelinedStore``; after every
submit the client collects every result but the newest ``queue_depth - 1``,
in order.  A request's latency runs from its group's first submit to its
wave's result.  Past the stream's last group the client starts again at its
first, each pass writing values of its own.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, guard, trace, traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


# ---------------------------------------------------------------------------
# the files found by name
# ---------------------------------------------------------------------------


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(manifest: dict, name: str) -> dict:
    for c in manifest["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, base: Path = HERE) -> dict:
    with open(base / kind / f"{name}.json") as f:
        return json.load(f)


def metric_reader(name: str, base: Path = HERE):
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"kvbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(manifest: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with ``workloads`` only in those."""
    group = manifest["per_layer"] if traced else manifest["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------


class Program:
    """The deployment a configuration names, behind ``PipelinedStore``."""

    def __init__(self, cfg: dict, keys: np.ndarray, vals: np.ndarray, device):
        from repro_torch.core import CacheConfig, DPAStore, ScanCacheConfig, TreeConfig
        from repro_torch.serving.pipeline import PipelinedStore

        tree = TreeConfig(**cfg["tree"])
        hot = CacheConfig(**cfg["hot_cache"]) if cfg.get("hot_cache") else None
        scan = ScanCacheConfig(**cfg["scan_cache"]) if cfg.get("scan_cache") else None
        if cfg["partition"] == "single":
            self.store = DPAStore(keys, vals, tree, cache_cfg=hot, scan_cache_cfg=scan, device=device)
        else:
            from repro_torch.distributed.kvshard import ShardedDPAStore

            self.store = ShardedDPAStore(
                keys,
                vals,
                int(cfg["shards"]),
                tree,
                cache_cfg=hot,
                partition=cfg["partition"],
                scan_cache_cfg=scan,
                replication=int(cfg["replication"]),
                device=device,
            )
        self.pipe = PipelinedStore(self.store, queue_depth=int(cfg["queue_depth"]))

    def counters(self) -> Dict[str, int]:
        """The store's counters summed over its shards (drained first)."""
        if hasattr(self.store, "stats_totals"):
            return dict(self.store.stats_totals())
        return {k: int(v) for k, v in vars(self.store.stats).items() if isinstance(v, (int, np.integer))}

    def shard_drain_ns(self) -> Optional[np.ndarray]:
        s = getattr(self.store, "shard_drain_ns", None)
        return None if s is None else np.array(s, dtype=np.int64)

    def ledger_records(self) -> list:
        return list(self.pipe.ledger.records)

    def close(self) -> None:
        self.pipe = None
        self.store = None


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------


@dataclass
class GroupLog:
    g: int  # global group index: stream row g % G, pass g // G
    results: Optional[dict]  # kept answers by kind, or None
    status: Optional[np.ndarray] = None  # the write wave's statuses
    pinned: bool = False  # answers kept whatever the reservoir does
    sampled: bool = False  # in the reservoir


class Client:
    """The closed-loop client: runs groups through the pipeline, records each
    wave's latency and keeps the answers the check will compare."""

    def __init__(self, pipe, stream: traffic.Stream, tr: dict, depth: int, keep: int, seed: int):
        self.pipe = pipe
        self.stream = stream
        self.depth = depth
        self.limit = int(tr.get("scan_wave", {}).get("limit", 0))
        self.max_leaves = int(tr.get("scan_wave", {}).get("max_leaves", 4))
        self.pending = deque()
        self.log: List[GroupLog] = []
        self.lat_n: List[int] = []
        self.lat_s: List[float] = []
        self.lat_g: List[int] = []
        self.waves = {"read": 0, "scan": 0, "write": 0}
        self.t_group: List[float] = []  # each group's first submit
        # a seeded reservoir of groups whose answers are kept for the check
        self._rng = np.random.default_rng([int(seed), 0x5EED])
        self._keep = keep
        self._kept: List[GroupLog] = []
        self._seen = 0
        c = stream.counts
        self.n = {"read": c["read"], "scan": c["scan"], "write": c["update"] + c["insert"]}

    def _offer(self, e: GroupLog) -> None:
        """Reservoir sampling over the groups (Algorithm R): each group's
        answers stay if the reservoir holds it, the newest group's until the
        next one starts."""
        self._seen += 1
        if len(self._kept) < self._keep:
            self._kept.append(e)
            e.sampled = True
            return
        j = int(self._rng.integers(self._seen))
        if j < self._keep:
            out = self._kept[j]
            self._kept[j] = e
            e.sampled = True
            out.sampled = False
            if not out.pinned:
                out.results = None

    def run_group(self, g: int, pinned: bool = False) -> int:
        if self.log:
            prev = self.log[-1]
            if not prev.sampled and not prev.pinned:
                prev.results = None
        e = GroupLog(g=g, results={}, pinned=pinned)
        self._offer(e)
        self.log.append(e)
        s = self.stream
        row, p = g % s.groups, g // s.groups
        t0 = time.perf_counter()
        self.t_group.append(t0)
        if self.n["read"]:
            self._submit(t0, "read", e, self.pipe.submit_get(s.read_keys[row]))
        if self.n["scan"]:
            t = self.pipe.submit_range(s.scan_starts[row], self.limit, max_leaves=self.max_leaves)
            self._submit(t0, "scan", e, t)
        if self.n["write"]:
            self._submit(t0, "write", e, self.pipe.submit_put(s.write_keys[row], check.written(s, row, p)))
        return s.group_ops()

    def _submit(self, t0, kind, e, ticket) -> None:
        self.pending.append((t0, kind, e, ticket))
        self.waves[kind] += 1
        self.collect()

    def collect(self, force: bool = False) -> None:
        keep = 0 if force else self.depth - 1
        while len(self.pending) > keep:
            t0, kind, e, ticket = self.pending.popleft()
            res = self.pipe.result(ticket)
            self.lat_n.append(self.n[kind])
            self.lat_s.append(time.perf_counter() - t0)
            self.lat_g.append(e.g)
            if kind == "write":
                e.status = res
            elif e.results is not None:
                e.results[kind] = res


def read_back(pipe, keys: np.ndarray, wave: int):
    """GET every key through the entry, in waves of ``wave``."""
    vals, found = [], []
    for i in range(0, keys.size, wave):
        v, f = pipe.result(pipe.submit_get(keys[i : i + wave]))
        vals.append(np.asarray(v))
        found.append(np.asarray(f))
    return keys, np.concatenate(vals), np.concatenate(found)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    out.update(over or {})
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(
    cell_name: str,
    seed: int,
    seconds: float,
    traced: bool,
    *,
    device="cuda",
    t_start: Optional[float] = None,
    manifest: Optional[dict] = None,
    base: Path = HERE,
    overrides: Optional[dict] = None,
    control: Optional[str] = None,
    log=print,
) -> dict:
    """Run ``cell_name`` once and return the result object (the last line a
    run prints).  ``overrides`` replaces keys of the configuration and the
    traffic (the CPU tests' small sizes); ``control`` puts the reference with
    that fault in the program's place."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    manifest = load_manifest(base.parent) if manifest is None else manifest
    cell = find_cell(manifest, cell_name)
    overrides = overrides or {}
    cfg = _merge(load_json("configs", cell["config"], base), overrides.get("config"))
    tr = _merge(load_json("traffic", cell["traffic"], base), overrides.get("traffic"))
    wanted = metrics_of(manifest, cell_name, traced)
    readers = {m["name"]: metric_reader(m["name"], base) for m in wanted}
    parts = {}

    def part(name, t0):
        parts[name] = time.perf_counter() - t0

    t = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        kind = torch.cuda.get_device_name(device)
        torch.cuda.reset_peak_memory_stats(device)
    else:
        kind = "cpu"
    part("device_init", t)
    if device.type == "cuda" and control is None:
        t = time.perf_counter()
        from repro_torch.kernels import build

        build.build_all()
        part("kernel_build", t)

    # a traffic that fixes its data (``data_seed``) draws the keys and the
    # stream from it; the run's seed then orders the groups and the values
    data_seed = int(tr.get("data_seed", seed))
    t = time.perf_counter()
    keys_dev = traffic.draw_sparse_keys(int(cfg["records"]), data_seed, device)
    keys = traffic.to_u64(keys_dev)
    vconst = np.uint64(np.random.default_rng([int(seed), 0xBA1]).integers(0, 2**63, dtype=np.int64))
    vals = keys ^ vconst
    _sync(device)
    part("keys", t)

    t = time.perf_counter()
    stream = traffic.draw_stream(keys_dev, tr, int(cfg["wave_size"]), data_seed, device)
    if data_seed != seed:
        stream = traffic.reorder(stream, seed)
    del keys_dev
    if device.type == "cuda":
        torch.cuda.empty_cache()
    part("stream", t)
    if stream.counts["scan"] and int(tr["scan_length"]["max"]) > int(tr["scan_wave"]["limit"]):
        raise ValueError("a scan length above the wave's limit cannot be answered")

    t = time.perf_counter()
    if control is None:
        program = Program(cfg, keys, vals, device)
    else:
        from .control import ControlProgram

        program = ControlProgram(keys, vals, control)
    _sync(device)
    part("store_build", t)

    if traced:
        # load the profiler's tracing library now, not in the window
        t = time.perf_counter()
        with torch.profiler.profile():
            torch.zeros(1, device=device).add_(1)
        part("profiler_init", t)

    keep = int(tr.get("check_groups", 8))
    client = Client(program.pipe, stream, tr, int(cfg["queue_depth"]), keep, seed)
    t = time.perf_counter()
    g = 0
    for _ in range(int(tr.get("warmup_groups", 1))):
        client.run_group(g)
        g += 1
    client.collect(force=True)
    _sync(device)
    part("warmup", t)

    before = program.counters()
    drain_before = program.shard_drain_ns()
    n_led = len(program.ledger_records())
    log_start = len(client.log)
    lat_start = len(client.lat_n)
    waves_before = dict(client.waves)
    sl = trace.Slice(device) if traced else None
    slice_ops, slice_groups, slice_t0, slice_t1, slice_done = 0, [], None, None, False
    profile_s = float(tr.get("profile_seconds", 0.25))

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    ops = 0
    while True:
        now = time.perf_counter()
        in_slice = sl is not None and not slice_done and now - t0 >= seconds / 2
        if in_slice and slice_t0 is None:
            sl.start()
            slice_t0 = time.perf_counter()
        n = client.run_group(g, pinned=in_slice)
        if in_slice:
            slice_ops += n
            slice_groups.append(g)
            if time.perf_counter() - slice_t0 >= profile_s:
                client.collect(force=True)
                sl.stop()
                slice_t1 = time.perf_counter()
                slice_done = True
        g += 1
        ops += n
        if time.perf_counter() - t0 >= seconds:
            break
    client.collect(force=True)
    t1 = time.perf_counter()
    if sl is not None and slice_t0 is not None and not slice_done:
        sl.stop()
        slice_t1 = time.perf_counter()
        slice_done = True
    guard.require_clean("after the window")

    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    after = program.counters()
    drain_after = program.shard_drain_ns()
    records = program.ledger_records()[n_led:]
    if slice_t0 is not None:
        # the profiled slice's waves are left out of the host-clock metrics
        a, b = int(slice_t0 * 1e9), int(slice_t1 * 1e9)
        records = [r for r in records if r.t_drain1 < a or r.t_issue0 > b]
    wave_ops = {"get": client.n["read"], "range": client.n["scan"], "put": client.n["write"]}
    window_log = client.log[log_start:]
    writes = sum(e.status.size for e in window_log if e.status is not None)
    acked = sum(int((np.asarray(e.status) == check.STATUS_OK).sum()) for e in window_log if e.status is not None)
    t = time.perf_counter()
    rb = check.acked_keys(stream, client.log)
    readback = read_back(program.pipe, rb, int(cfg["wave_size"])) if rb.size else None
    readback_s = time.perf_counter() - t
    program.close()
    client.pipe = None
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    compared = check.judge(keys, vals, stream, client.log, int(tr.get("scan_wave", {}).get("limit", 0)), readback)
    check_s = time.perf_counter() - t
    checked_groups = sum(1 for e in client.log if e.results is not None)

    rec = {
        "cell": cell_name,
        "config": cfg,
        "traffic": tr,
        "device": {"kind": kind},
        "setup": {"total_s": setup_s, "parts": parts},
        "window": {
            "seconds": t1 - t0,
            "ops": ops,
            "groups": len(window_log),
            "waves": {k: client.waves[k] - waves_before[k] for k in client.waves},
            "writes": writes,
            "writes_acked": acked,
        },
        "latency": _latency(client, lat_start, set(slice_groups)),
        "ledger": {
            "waves": len(records),
            "ops": sum(wave_ops.get(r.kind, 0) for r in records),
            "issue_ns": sum(r.issue_ns for r in records),
            "drain_ns": sum(r.drain_ns for r in records),
        },
        "counters": {k: after.get(k, 0) - before.get(k, 0) for k in after},
        "shard_drain_ns": None if drain_after is None else drain_after - drain_before,
        "trace": None,
    }
    if sl is not None and slice_done:
        summary = trace.summarize(sl.events())
        if summary is not None:
            summary.update(_slice_work(stream, client.log, slice_groups, slice_ops))
        rec["trace"] = summary

    metrics = {}
    for m in wanted:
        v = readers[m["name"]](rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": kind,
        "count": 1,
        "memory_peak_bytes": peak,
    }
    out = {"correct": None, "attempted": ops, "failed": writes - acked, "metrics": metrics, "device": dev}
    if traced and rec["trace"] is not None:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = {"device_ops": rec["trace"]["top_ops"], "idle_gaps": rec["trace"]["idle_gaps"]}
    limits = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in compared.items()}
    out["correct"] = bool(limits) and all(x["value"] <= x["limit"] for x in limits.values())
    out["check"] = limits
    log(
        json.dumps(
            {
                "setup_parts_s": parts,
                "readback_s": readback_s,
                "readback_keys": int(rb.size),
                "check_s": check_s,
                "checked_groups": checked_groups,
                "groups": len(client.log),
                "window_s": t1 - t0,
                "group_s_p10_p50_p90": _deciles(client.t_group[log_start:] + [t1]),
            }
        )
    )
    return out


def _deciles(starts: List[float]) -> List[float]:
    d = np.diff(np.array(starts))
    return [float(x) for x in np.percentile(d, [10, 50, 90])] if d.size else []


def _latency(client: Client, start: int, leave_out: set) -> dict:
    """Each window wave's request count and latency, the profiled slice's
    groups left out."""
    keep = [i for i in range(start, len(client.lat_g)) if client.lat_g[i] not in leave_out]
    return {"n": np.array(client.lat_n, dtype=np.int64)[keep], "s": np.array(client.lat_s)[keep]}


def _slice_work(stream: traffic.Stream, log: List[GroupLog], groups: List[int], ops: int) -> dict:
    """The requests the profiled groups made, counted from the stream and
    from their answers: GET requests and distinct keys per GET wave, scan
    requests and the rows each request asked for and got."""
    G = stream.groups
    by_g = {e.g: e for e in log}
    out = {"ops": ops, "get_requests": 0, "get_distinct": 0, "scan_requests": 0, "scan_rows": 0}
    for g in groups:
        row = g % G
        if stream.counts["read"]:
            out["get_requests"] += stream.counts["read"]
            out["get_distinct"] += int(np.unique(stream.read_keys[row]).size)
        if stream.counts["scan"]:
            res = (by_g[g].results or {}).get("scan")
            if res is not None:
                out["scan_requests"] += stream.counts["scan"]
                out["scan_rows"] += int(np.minimum(np.asarray(res.counts), stream.scan_lens[row]).sum())
    return out
