"""ROLEX comparison baseline (Sec 4.3) — calibrated RDMA cost model.

A copy of the JAX package's ``core/rolex_model.py`` (numbers only; it
imports no JAX, but the port imports nothing of that package).

ROLEX [25] is an RDMA-based learned KV store with *stateful clients*: each
client holds the learned models locally, predicts the remote leaf location,
and issues one-sided RDMA reads/writes.  Running ROLEX itself requires RDMA
NICs we do not have, so — like the paper models its own hardware — we model
ROLEX's request cost structure and calibrate the constants against the
throughput/latency levels the paper reports for its testbed (Fig 15, six
ConnectX-5 clients over 100 Gb/s RoCE):

  * GET: one RDMA read of the predicted leaf region when the local model is
    fresh; a fraction (model staleness + eps overshoot) needs a second read.
  * INSERT: one RDMA write into a leaf's insert slot (leaf-atomic shift) —
    server memory-bandwidth-bound, no host CPU on the fast path; retrain is
    asynchronous and off the critical path.  This is why ROLEX INSERT beats
    DPA-Store (8+ vs 1.7 MOPS): no 120 MB/s stitch funnel.
  * RANGE: predicted leaf read + successor leaf reads (client re-predicts).
  * epsilon sensitivity: ROLEX uses eps in {128, 256}; on smooth datasets
    that wastes read bytes, on hard datasets (osmc) it wins by needing fewer
    segments (paper: "ROLEX achieves better results on osmc").

Client-side state cost (the architectural point the paper presses): every
client replicates model metadata — ~6.5 % of a 500 M dataset per client.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RolexParams:
    rdma_read_us: float = 1.9  # one-sided read incl. fabric + PCIe at QD~32
    rdma_write_us: float = 1.55  # one-sided write (doorbell + payload)
    client_qps_cap: float = 46.0e6  # 6 clients x 31 threads saturation cap
    second_read_frac: float = 0.18  # stale-model / overshoot re-reads
    nic_iops_cap: float = 35.0e6  # server RNIC message-rate ceiling
    metadata_frac: float = 0.065  # per-client model replica (paper Sec 4.2.1)


def _cap(mops: float, p: RolexParams) -> float:
    return min(mops, p.nic_iops_cap / 1e6, p.client_qps_cap / 1e6)


def get_mops(dataset: str, p: RolexParams = RolexParams()) -> float:
    """Point-lookup throughput.  Dataset affects the re-read fraction:
    smoother CDFs predict better.  Calibration anchors: sparse/amzn below
    DPA-Store's 33 MOPS, osmc above DPA-Store's eps=16 configuration."""
    second = {
        "sparse": 0.16,
        "sparseBig": 0.18,
        "dense4x": 0.12,
        "wiki": 0.12,
        "amzn": 0.22,
        "osmc": 0.10,  # large-eps models fit osmc well -> fewer re-reads
        "face": 0.25,
    }.get(dataset, p.second_read_frac)
    reads_per_get = 1.0 + second
    # ~62 in-flight one-sided reads per client thread pipeline across 186
    # threads; effective concurrency limited by RNIC parallelism ~ 64
    concurrency = 64
    return _cap(concurrency / (reads_per_get * p.rdma_read_us), p)


def insert_mops(p: RolexParams = RolexParams()) -> float:
    """One RDMA write per insert; server-side async retrain off path."""
    concurrency = 22  # write path: doorbell ordering limits pipelining
    return _cap(concurrency / p.rdma_write_us, p)


def update_mops(p: RolexParams = RolexParams()) -> float:
    return insert_mops(p)


def range_mops(limit: int = 10, p: RolexParams = RolexParams()) -> float:
    """Predicted leaf read + ~1 successor read per 64 results."""
    reads = 1.0 + p.second_read_frac + max(0, (limit - 1)) / 64.0
    # range reads pull whole leaf regions (eps in {128,256} -> 2-4 KB per
    # read); payload serialisation halves the effective read pipelining
    # relative to 16 B point GETs.
    concurrency = 24
    return _cap(concurrency / (reads * p.rdma_read_us), p)


def get_latency_us(qd: int = 32, p: RolexParams = RolexParams()) -> float:
    """Mean GET latency at queue depth ``qd`` — RDMA contention grows with
    in-flight requests (paper: 'noticeable contention delays for more
    in-flight requests'; DPA-Store shows lower latencies in all Fig 15)."""
    return p.rdma_read_us * (1 + p.second_read_frac) * (1 + qd / 16.0)


def ycsb_mops(workload: str, dataset: str, p: RolexParams = RolexParams()) -> float:
    """Blend per-op models with YCSB mix ratios (Sec 4.3)."""
    mixes = {
        "A": {"get": 0.5, "update": 0.5},
        "B": {"get": 0.95, "update": 0.05},
        "C": {"get": 1.0},
        "D": {"get": 0.95, "insert": 0.05},
        "E": {"range": 0.95, "insert": 0.05},
        "F": {"get": 0.5, "rmw": 0.5},
    }
    mix = mixes[workload.upper()]
    rates = {
        "get": get_mops(dataset, p),
        "update": update_mops(p),
        "insert": insert_mops(p),
        "range": range_mops(10, p),
        # read-modify-write = a read plus a write
        "rmw": 1.0 / (1.0 / get_mops(dataset, p) + 1.0 / update_mops(p)),
    }
    # harmonic blend (ops interleave on the same resources)
    denom = sum(frac / rates[op] for op, frac in mix.items())
    return 1.0 / denom


def client_state_bytes(n_keys: int, p: RolexParams = RolexParams()) -> float:
    """Per-client replicated metadata (DPA-Store's is zero — the point)."""
    return n_keys * 16 * p.metadata_frac
