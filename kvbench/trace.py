"""The device slice of a traced run: ``torch.profiler`` over a few steady
groups, and the reduction of its Chrome trace to the numbers the device
metrics read.

The pipeline names every issue and drain phase ``kv/<kind>/issue#<seq>`` or
``kv/<kind>/drain#<seq>`` (``torch.profiler.record_function``); a device
operation belongs to the innermost such span around the runtime call that
launched it.  The slice itself is the span ``kvbench/slice``, closed after a
device synchronise, so every operation launched in it ends inside it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional

import torch

SLICE = "kvbench/slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
WAVE_KINDS = {"get": "read", "range": "scan", "put": "write", "delete": "write"}


class Slice:
    """Start and stop ``torch.profiler`` around part of the window."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self._span = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._span = torch.profiler.record_function(SLICE)
        self._span.__enter__()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._span.__exit__(None, None, None)
        self.prof.stop()

    def events(self) -> List[dict]:
        """The trace's events, through a file under ``TMPDIR`` that is removed
        once read."""
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(path)


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(spans, starts, t: float, lookback: int = 256):
    """The span of ``spans`` (sorted by start) around ``t`` that starts last."""
    i = bisect.bisect_right(starts, t) - 1
    stop = max(-1, i - lookback)
    while i > stop:
        s = spans[i]
        if s[0] <= t <= s[1]:
            return s
        i -= 1
    return None


def _span_kind(name: str) -> Optional[str]:
    parts = name.split("/")
    if len(parts) == 3 and parts[2].split("#")[0] in ("issue", "drain"):
        return parts[1]
    return None


def summarize(events: List[dict], top: int = 10) -> Optional[Dict]:
    """Busy and window seconds of the slice, device seconds by wave kind,
    the count of device operations, the top device operations and the
    longest idle gaps by what the host was doing.  None without a slice."""
    sl = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE and e.get("cat") == "user_annotation"]
    if not sl:
        return None
    s0 = float(sl[0]["ts"])
    s1 = s0 + float(sl[0]["dur"])
    main_tid = sl[0].get("tid")
    runtime = {}
    spans = []  # (start, end, name) of the pipeline's phases
    cpu_ops = []  # (start, end, name) on the thread that drives the loop
    dev = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts = float(e.get("ts", 0.0))
        dur = float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in RUNTIME_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                runtime[corr] = ts
        elif cat == "user_annotation" and _span_kind(e.get("name", "")):
            spans.append((ts, ts + dur, e["name"]))
        elif cat == "cpu_op" and e.get("tid") == main_tid:
            cpu_ops.append((ts, ts + dur, e.get("name", "")))
    spans.sort()
    span_starts = [s[0] for s in spans]
    cpu_ops.sort()
    cpu_starts = [c[0] for c in cpu_ops]
    by_kind = defaultdict(float)
    by_name = defaultdict(float)
    iv = []
    n_ops = 0
    for e in dev:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        launched = runtime.get((e.get("args") or {}).get("correlation"), a)
        if not (s0 <= launched <= s1):
            continue
        n_ops += 1
        iv.append((max(a, s0), min(b, s1)))
        by_name[e.get("name", "?")[:80]] += (b - a) / 1e6
        sp = _innermost(spans, span_starts, launched)
        kind = WAVE_KINDS.get(_span_kind(sp[2]), "other") if sp else "other"
        by_kind[kind] += (b - a) / 1e6
    merged = _merge([x for x in iv if x[1] > x[0]])
    busy = sum(b - a for a, b in merged)
    gaps = defaultdict(float)
    edges = [s0] + [x for ab in merged for x in ab] + [s1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        m = (a + b) / 2
        sp = _innermost(spans, span_starts, m)
        op = _innermost(cpu_ops, cpu_starts, m)
        what = sp[2].split("#")[0] if sp else "client"
        if op:
            what += ": " + op[2][:60]
        gaps[what] += (b - a) / 1e6
    return {
        "window_s": (s1 - s0) / 1e6,
        "busy_s": busy / 1e6,
        "device_ops": n_ops,
        "device_s_by_kind": dict(by_kind),
        "top_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:top],
    }
