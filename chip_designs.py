#!/usr/bin/env python3
"""Time on one CUDA card the kernel shapes that kernels B1 (GET), B2 (cache
probe) and B4 (paged gather) choose between, each held bitwise against its
plain version.

    python3 chip_designs.py          # about four minutes on an H100
    python3 chip_designs.py b2       # only the named sections: b4, b1, b2

Kernel B4 (``csrc/paged_gather.cu``) at 59, 1024 and 16384 random slots of
two bf16 pools of 65536 32-KiB blocks, one pool and the K and V pair:
the bulk path with 4 and 16 KiB items, the word path with 16 KiB items and
with whole 32-KiB blocks (one CTA per block, the layout of the first port),
what ``launch_plan`` picks, and ``index_select``.  Kernel B1
(``csrc/traverse.cu``) on a 50M-key store (uniform u64 keys drawn on the
card, default tree config, a few buffered writes) at zipf-0.99 waves of
1 to 65536 requests: a warp per request, a thread per request (CTAs of 128
and 256 threads), and what ``get_plan`` picks; warm, and from a cold L2.
Kernel B2 (``csrc/cache_probe.cu``) on the same store after two more
zipf-0.99 GET waves and a RANGE wave have filled its hot-entry (P=2) and
scan-anchor (P=1) caches, at zipf-0.99 waves of 1, 1024, 8192 and 65536
requests: every shape of ``cache_probe.DESIGNS`` (the first port's way loop
at its CTA of 256; 16-byte loads of the bucket speculative, Bloom-gated,
with the flags and payload read after a key match, and both; the generic
32-bit shape), the vector and lean shapes also with CTAs of 256, and what
``probe_plan`` picks, warm and cold (medians of 51 launches), with the
wave's Bloom-positive and hit shares.  First, the launch floor: the same
timer around ``fill_`` of a 1-element tensor, warm and cold.

Every line is one JSON object; the card's name and power limit come first,
as ``nvidia-smi`` gives them.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

B2_WAVES = (1, 1024, 8192, 65536)
REPS = 51  # B2's designs differ by tenths of a microsecond: a median of 51 launches
NB, BLOCK = 65536, (16, 8, 128)  # the paged cell's pool: llama3-405b's KV heads, bf16
N_KEYS = 50_000_000
WAVES = (1, 1024, 4096, 8192, 65536)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def b2_designs(torch, st, time_ms, z2, sm) -> None:
    """Kernel B2's shapes on ``st``'s caches, after two GET waves and a
    RANGE wave of ``z2``; the probed keys come after those."""
    from repro_torch.core import cacheset, hotcache, scancache
    from repro_torch.core.keys import u32
    from repro_torch.kernels import cache_probe

    W = 65536
    st.get(z2[:W])
    st.get(z2[W : 2 * W])
    st.range(z2[2 * W : 3 * W], limit=10)
    c, sc = st.cache, st.scan_cache
    caches = {
        2: (c, c.bval, st.cache_cfg, hotcache.SALT_BLOOM, hotcache.SALT_BUCKET),
        1: (sc, sc.bleaf[..., None], st.scan_cache_cfg, scancache.SALT_SBLOOM, scancache.SALT_SBUCKET),
    }
    for P, (cache, bpay, cfg, salts, bsalt) in caches.items():
        kw = dict(bloom_bits=cfg.bloom_bits, n_buckets=cfg.n_buckets, salts_bloom=salts, salt_bucket=bsalt)
        aligned = cache_probe.vector_aligned(cache.bkey, bpay, cache.bvalid)
        for B in B2_WAVES:
            khi, klo = st._limbs(z2[3 * W : 3 * W + B])
            tid = hotcache.steer(khi, klo, cfg.n_threads)
            args = (cache.bloom, cache.bkey, bpay, cache.bvalid, tid, khi, klo)
            want = cache_probe.probe_plain(*args, **kw)
            may = cacheset.bloom_may(cache.bloom, tid, u32(khi), u32(klo), cfg.bloom_bits, salts)
            plan = cache_probe.probe_plan(B, cfg.ways, P, aligned, sm)
            row = {"b2_p": P, "requests": B, "bloom_positive": float(may.float().mean()),
                   "hit": float(want[0].float().mean()), "plan_shape": plan._asdict()}
            shapes = {d: cache_probe.shape(d, B, threads=256 if d == "loop" else cache_probe.THREADS)
                      for d in cache_probe.DESIGNS if cache_probe.serves(d, cfg.ways, P, aligned)}
            shapes.update({f"{d}_256": cache_probe.shape(d, B, threads=256) for d in ("vector", "lean")})
            calls = {name: (lambda pl=pl: cache_probe.launch(*args, plan=pl, **kw)) for name, pl in shapes.items()}
            calls["plan"] = lambda: cache_probe.probe_cuda(*args, **kw)
            for name, call in calls.items():
                got = call()
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (name, P, B)
                row[name] = time_ms(torch, call, reps=REPS)
                row[name + "_cold"] = time_ms(torch, call, reps=REPS, cold=True)
            emit(row)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_designs: no CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from chip_smoke import draw_sparse_keys, time_ms
    from repro_torch.core import DPAStore, datasets
    from repro_torch.kernels import build, paged_gather, traverse

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    sm = build.sm_count(dev.index or 0)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    sections = set(sys.argv[1:]) or {"b4", "b1", "b2"}
    floor = torch.zeros(1, device=dev)
    emit({"launch_floor_ms": time_ms(torch, lambda: floor.fill_(0)),
          "launch_floor_cold_ms": time_ms(torch, lambda: floor.fill_(0), cold=True)})

    # ---- B4 ------------------------------------------------------------
    if "b4" in sections:
        gen = torch.Generator(device=dev).manual_seed(1)
        pools = [torch.empty((NB, *BLOCK), dtype=torch.bfloat16, device=dev).normal_(generator=gen) for _ in range(2)]
        block_bytes = int(np.prod(BLOCK)) * 2
        gather = build.function("paged_gather", "dpa_paged_gather", n_ptrs=5, n_ints=10)

        def launch(ps, slots, plan):
            outs = [torch.empty((slots.numel(), *BLOCK), dtype=torch.bfloat16, device=dev) for _ in ps]
            err = gather(ps[0].data_ptr(), ps[-1].data_ptr(), slots.data_ptr(), outs[0].data_ptr(), outs[-1].data_ptr(),
                         len(ps), NB, block_bytes, slots.numel(), plan.chunk, plan.grid, plan.threads, plan.smem,
                         int(plan.bulk), 16, stream())
            build.check(err, "paged_gather")
            return outs

        def shape(bulk, chunk, threads, items):
            if not bulk:
                return paged_gather.GatherPlan(False, chunk, 0, items, items, threads, 0)
            smem = paged_gather.STAGES * chunk
            per_sm = min(paged_gather.CTAS_PER_SM, paged_gather.SMEM_PER_SM // (smem + paged_gather.SMEM_RESERVED))
            return paged_gather.GatherPlan(True, chunk, 0, items, min(items, sm * per_sm), 32, smem)

        rng = np.random.default_rng(0)
        for n in (59, 1024, 16384):
            slots = torch.from_numpy(rng.choice(NB, n, replace=False).astype(np.int32)).to(dev)
            clamped = paged_gather.clamp_slots(slots, NB)
            want = [p.index_select(0, clamped).view(torch.int16) for p in pools]
            row = {"b4_slots": n, "bound_ms": 2 * n * block_bytes / 3.35e9, "pair_bound_ms": 4 * n * block_bytes / 3.35e9}
            designs = {f"bulk_{c // 1024}k": (True, c, 32) for c in (4096, 16384)}
            designs.update({"word_16k": (False, 16384, 256), "word_block": (False, 32768, 256)})
            for k in (1, 2):
                for name, (bulk, chunk, threads) in designs.items():
                    plan = shape(bulk, chunk, threads, k * n * (-(-block_bytes // chunk)))
                    got = launch(pools[:k], slots, plan)
                    assert all(torch.equal(g.view(torch.int16), w) for g, w in zip(got, want)), (name, k)
                    row[f"{name}_{k}"] = time_ms(torch, lambda: launch(pools[:k], slots, plan))
                wrap = paged_gather.gather_cuda if k == 1 else paged_gather.gather_kv_cuda
                row[f"plan_{k}"] = time_ms(torch, lambda: wrap(*pools[:k], slots))
                row[f"index_select_{k}"] = time_ms(torch, lambda: [p.index_select(0, clamped) for p in pools[:k]])
            row["plan"] = {k: paged_gather.launch_plan(block_bytes, n, k, sm, True).bulk for k in (1, 2)}
            emit(row)
        del pools, want
        torch.cuda.empty_cache()

    if not sections & {"b1", "b2"}:
        return 0

    # ---- B1 and B2: a store of 50M keys ---------------------------------
    keys = draw_sparse_keys(torch, dev, N_KEYS, 0)
    st = DPAStore(keys, keys ^ np.uint64(0x5DEECE66D), device=dev)
    z = keys[datasets.zipf_indices(keys.size, 3 * 65536, alpha=0.99, seed=0)]
    st.get(z[:65536])
    st.put(z[65536:69000], z[65536:69000])
    t, ib = st.tree, st.ib
    get = build.function("traverse", "dpa_get", n_ptrs=22, n_ints=8)
    kw = dict(depth=st.depth, eps_inner=st.cfg.eps_inner, eps_leaf=st.cfg.eps_leaf)
    if "b1" in sections:
        emit({"b1_keys": int(keys.size), "depth": st.depth})
        for B in WAVES:
            khi, klo = st._limbs(z[2 * 65536 : 2 * 65536 + B])
            want = traverse.get_plain(t, ib, khi, klo, **kw)
            outs = [torch.empty(B, dtype=torch.int32, device=dev), torch.empty(B, dtype=torch.int32, device=dev),
                    torch.empty(B, dtype=torch.bool, device=dev)]
            ptrs = [p.data_ptr() for p in (t.root, t.node_seg_first, t.node_seg_slope, t.node_seg_count, t.node_seg_slot,
                                            t.pivot_keys, t.pivot_child, t.leaf_anchor, t.leaf_slope, t.leaf_count,
                                            t.leaf_slot, t.hbm_keys, t.hbm_vals, ib.keys, ib.vals, ib.op, ib.count,
                                            khi, klo, *outs)]

            def run(warp, threads):
                per_cta = threads // 32 if warp else threads
                err = get(*ptrs, B, st.depth, st.cfg.eps_inner, st.cfg.eps_leaf, ib.keys.shape[1], int(warp), threads,
                          -(-B // per_cta), stream())
                build.check(err, "get")

            row = {"b1_requests": B, "plan_warp": traverse.get_plan(B, st.cfg.eps_inner, st.cfg.eps_leaf, sm,
                                                                     traverse._ctas_per_sm).warp}
            for name, (warp, threads) in {"warp": (True, min(256, 32 * B)), "thread_128": (False, 128),
                                          "thread_256": (False, 256)}.items():
                for o in outs:
                    o.fill_(7)
                run(warp, threads)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(outs, want)), (name, B)
                row[name] = time_ms(torch, lambda: run(warp, threads))
                row[name + "_cold"] = time_ms(torch, lambda: run(warp, threads), cold=True)
            emit(row)

    if "b2" in sections:
        b2_designs(torch, st, time_ms, keys[datasets.zipf_indices(keys.size, 4 * 65536, alpha=0.99, seed=1)], sm)
    return 0


if __name__ == "__main__":
    sys.exit(main())
