"""Analytic performance model of DPA-Store on BlueField-3 (paper Sec 4.2.6),
a copy of the JAX package's ``core/perfmodel.py`` (which imports nothing).

The model derives throughput from memory accesses, parameterised by the
paper's hardware constants (Chen et al. [6] / paper Sec 2.3):

    DPA memory access   465 ns
    DMA to host memory  910 ns
    DPA L3 hit           64 ns
    host->DPA stitch bandwidth ~120 MB/s  (measured in Sec 4.2.7)
    176 traverser threads, 4 stitcher, 4 patcher

Every number it returns describes that SmartNIC model, not the CUDA card.
The port's launcher uses :func:`pipelined_wave_mops`, the roofline of the
wave pipeline computed from its measured issue and drain times.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class HwParams:
    dpa_ns: float = 465.0  # DPA-memory access latency
    dma_ns: float = 910.0  # DPA -> host DMA latency
    l3_ns: float = 64.0  # DPA L3 hit
    traversers: int = 176
    stitchers: int = 4
    patchers: int = 4
    stitch_bw: float = 120e6  # B/s host->DPA (Sec 4.2.7)
    ping_mops: float = 44.9  # B3140L packet in-out ceiling (Sec 4.2.9)

    # B3220 variant: stronger packet matching, same DPA memory latency
    @staticmethod
    def b3220() -> "HwParams":
        return HwParams(ping_mops=44.9 * 1.69)


CACHE_LINE = 64


def pivot_lines(eps: int) -> float:
    """Average cache lines to scan a 2*eps key window (8 B keys), averaging
    the aligned and straddling cases — eps=4 -> 1.5 lines (paper)."""
    span = 2 * eps * 8
    aligned = math.ceil(span / CACHE_LINE)
    return (aligned + aligned + 1) / 2


def inner_node_lines(eps_inner: int, fullness: float = 0.5) -> float:
    """meta+firsts line, model line, pivot window, child pointer line.
    eps_inner=4 at 50 % fullness -> 4.5 lines (paper Sec 4.2.6)."""
    del fullness  # the window already averages alignment; kept for API clarity
    return 1 + 1 + pivot_lines(eps_inner) + 1


def get_time_us(
    depth: int,
    eps_inner: int = 4,
    eps_leaf: int = 8,
    root_cached: bool = True,
    hw: HwParams = HwParams(),
) -> float:
    """One full GET traversal in microseconds (no hot-entry cache hit)."""
    inner = inner_node_lines(eps_inner)
    t = 0.0
    levels = depth - 1
    for lvl in range(levels):
        lines = inner
        t_node = lines * hw.dpa_ns
        if lvl == 0 and root_cached:
            # root meta+model lines live in L3 for every thread
            t_node = (lines - 2) * hw.dpa_ns + 2 * hw.l3_ns
        t += t_node
    # leaf: 1 DPA line (meta/model/buffer head) + keys window DMA (contiguous
    # lines collapse into one DMA) + value DMA
    t += hw.dpa_ns + 2 * hw.dma_ns
    return t / 1000.0


def get_mops(
    depth: int,
    eps_inner: int = 4,
    eps_leaf: int = 8,
    root_cached: bool = True,
    threads: int | None = None,
    hw: HwParams = HwParams(),
    cache_hit_rate: float = 0.0,
) -> float:
    """Saturated GET throughput: threads / per-op latency, scheduling assumed
    to overlap one thread's compute with others' memory stalls (paper).  A
    hot-cache hit costs one DPA line (bucket) — bloom is free."""
    threads = threads or hw.traversers
    t_miss = get_time_us(depth, eps_inner, eps_leaf, root_cached, hw)
    t_hit = hw.dpa_ns / 1000.0
    t = cache_hit_rate * t_hit + (1 - cache_hit_rate) * t_miss
    return min(threads / t, hw.ping_mops)


def range_mops(
    depth: int,
    limit: int = 10,
    eps_inner: int = 4,
    eps_leaf: int = 8,
    hw: HwParams = HwParams(),
    anchor_hit_rate: float = 0.0,
) -> float:
    """RANGE throughput: one traversal + per-result staging (temp write on
    the DPA + its share of contiguous value DMA).  Calibrated shape: 10-key
    ranges on a depth-3 tree land at ~13 MOPS (paper Fig 15).

    ``anchor_hit_rate`` models the scan-anchor cache (``core/scancache``):
    a hit replaces the whole descent with one DPA line (the bucket probe —
    the Bloom filter rides the thread's resident context line, like the
    point cache), so the leaf walk starts immediately.  The per-result
    staging term is untouched: caching amortizes the descent, not the DMA.
    """
    t_get = get_time_us(depth, eps_inner, eps_leaf, True, hw)
    t_anchor = hw.dpa_ns / 1000.0
    t_descend = anchor_hit_rate * t_anchor + (1 - anchor_hit_rate) * t_get
    per_result_us = (hw.dpa_ns + hw.dma_ns / 4) / 1000.0
    return hw.traversers / (t_descend + limit * per_result_us)


def update_mops(
    hw: HwParams = HwParams(),
    depth: int = 3,
    ib_cap: int = 16,
    patch_handle_us: float = 5.3,
) -> float:
    """UPDATE-only workload = min(traverser bound, patcher bound).

    Traverser side: traversal + two atomic counters + entry write.  Patcher
    side: every ib_cap updates trigger one UPDATE patch; a patch costs the
    host ~patch_handle_us (request DMA poll + value rewrite + stitcher
    notification round trip ~ 2 x 910 ns + work, calibrated against the
    paper's 12.1 MOPS plateau at 4 patchers — Fig 9 right)."""
    t = get_time_us(depth, root_cached=True, hw=hw)
    t += 2 * hw.dpa_ns / 1000.0
    traverser_bound = hw.traversers / t
    patcher_bound = hw.patchers * ib_cap / patch_handle_us
    return min(traverser_bound, patcher_bound)


def insert_mops(
    dpa_bytes_per_insert: float,
    hw: HwParams = HwParams(),
    depth: int = 3,
) -> float:
    """INSERT throughput = min(traversal-bound, stitch-bandwidth-bound).

    The second term is the paper's bottleneck: every structural patch ships
    new leaf metadata + rebuilt pivot slots over the ~120 MB/s host->DPA
    path.  ``dpa_bytes_per_insert`` comes from the *measured* stitch
    accounting of the implementation (store.stats.stitched_dpa_bytes /
    inserts).  Paper: 1.7 MOPS -> ~70 B/insert."""
    compute_bound = update_mops(hw, depth)
    bw_bound = hw.stitch_bw / max(dpa_bytes_per_insert, 1e-9) / 1e6
    return min(compute_bound, bw_bound)


def bulk_load_seconds(dpa_bytes: int, hw: HwParams = HwParams()) -> float:
    """Bulk-load wall time = stitch payload / host->DPA bandwidth
    (Sec 4.2.7: 192 MB in ~1.6 s)."""
    return dpa_bytes / hw.stitch_bw


def mix_mops(
    mix: dict,
    depth: int = 3,
    eps_inner: int = 4,
    eps_leaf: int = 8,
    bytes_per_insert: float = 70.0,
    ib_cap: int = 16,
    patch_handle_us: float = 5.3,
    hw: HwParams = HwParams(),
) -> float:
    """Mixed-workload throughput (YCSB): ops share the traverser pool, but
    patches run on the host and stitches on their own DPA core, so the
    patcher/stitch bounds scale with the WRITE FRACTION, not the whole mix.
    This is why the paper's DPA-Store beats ROLEX at YCSB-A despite losing
    the pure-UPDATE comparison: at 50 % updates the patcher ceiling doubles.

    mix: {'get': f, 'update': f, 'insert': f, 'range': f, 'rmw': f}.
    """
    t_get = get_time_us(depth, eps_inner, eps_leaf, True, hw)
    t_append = 2 * hw.dpa_ns / 1000.0
    t_op = {
        "get": t_get,
        "update": t_get + t_append,
        "insert": t_get + t_append,
        "rmw": 2 * t_get + t_append,
        "range": t_get + 10 * (hw.dpa_ns + hw.dma_ns / 4) / 1000.0,
    }
    t_blend = sum(f * t_op[op] for op, f in mix.items())
    bounds = [hw.traversers / t_blend, hw.ping_mops]
    f_upd = mix.get("update", 0.0) + mix.get("rmw", 0.0)
    if f_upd > 0:
        bounds.append(hw.patchers * ib_cap / patch_handle_us / f_upd)
    f_ins = mix.get("insert", 0.0)
    if f_ins > 0:
        bounds.append(hw.stitch_bw / max(bytes_per_insert, 1e-9) / 1e6 / f_ins)
    return min(bounds)


def pipelined_wave_mops(
    wave_size: int,
    issue_us: float,
    drain_us: float,
    queue_depth: int = 2,
) -> float:
    """Roofline of the double-buffered host dispatch loop (``serving.
    pipeline``): with ``queue_depth`` waves in flight, the steady-state
    period per wave is bounded below by the longest single phase (the
    pipeline cannot go faster than its slowest stage) and by the total
    per-wave work divided by the depth (with qd slots, issue and drain of
    different waves overlap at best qd-fold).

        qd=1: period = issue + drain (the serial facade)
        qd>=2, balanced phases: period -> max(issue, drain) — the classic
        double-buffer bound, 2x the serial rate.

    ``issue_us``/``drain_us`` come from the measured WaveLedger; the
    returned MOPS is the ceiling the measured throughput is compared
    against in ``benchmarks/fig10_queue_depth.py``."""
    qd = max(int(queue_depth), 1)
    period = max(issue_us, drain_us, (issue_us + drain_us) / qd)
    return wave_size / max(period, 1e-9)


# -- paper's worked example, used as a self-check in tests -------------------


def paper_worked_example() -> dict:
    """Sec 4.2.6: depth 3, eps=(4,8): 6.47 us uncached -> 27.2 MOPS;
    root cached -> 31.05 MOPS."""
    hw = HwParams()
    t_uncached = get_time_us(3, 4, 8, root_cached=False, hw=hw)
    t_cached = get_time_us(3, 4, 8, root_cached=True, hw=hw)
    return {
        "t_uncached_us": t_uncached,
        "mops_uncached": hw.traversers / t_uncached,
        "t_cached_us": t_cached,
        "mops_cached": hw.traversers / t_cached,
    }
