#!/usr/bin/env python3
"""Drive the PyTorch port of DPA-Store on one CUDA card and check it.

    python3 chip_smoke.py            # 50M sparse keys, 65536-request waves

Phases, one JSON line each (any mismatch raises and exits non-zero):

1. device   — the card's name and power limit (also printed as
               ``nvidia-smi`` gives them), torch and CUDA versions, and the
               seconds spent building the CUDA kernels from ``src/repro_torch/csrc``.
2. kernels  — on the main-path store's state after some buffered writes and
               cache admits, each kernel (GET, cache probe P=2 and P=1, range
               walk) against its plain-torch version on the same CUDA tensors:
               bitwise equality and CUDA-event times (median of 25 launches);
               for GET and both probes also the time from a cold L2 (256 MB
               written before each launch) and the launch plan of the wave;
               for the probes the wave's Bloom-positive and hit shares and the
               launch floor (the same timer around ``fill_`` of a 1-element
               tensor).
3. main     — the single-store main path at a deployment's size: 50M sparse
               keys (the service config's and the paper's Table-1 scale),
               default tree/cache configs, YCSB-B waves (95% GET at zipf 0.99,
               5% UPDATE), a DELETE wave, RANGE waves (limit 10, a repeat for
               anchor-cache hits, limit 100 at one leaf per round), flush.
               Every GET and RANGE answer is checked against a numpy oracle,
               and the launch counters of B1-B3 must advance.  Prints the
               tree's inner nodes per level (what GET could stage).
   versioned — the deployment ``launch/serve.py`` documents for point-in-time
               reads and TTL (``--retain-epochs 64 --ttl 4``) as one store on
               phase 3's 50M keys: a pinned snapshot, 6 rounds of a zipf GET
               wave and a 5 % UPDATE wave of distinct keys with ``ttl=4``
               (a second snapshot after round 3), a filtered RANGE wave, ``as_of``
               GET and RANGE waves at both snapshots and a bounded ``as_of``
               resume, expiry, ``ttl_sweep`` (reads equal before and after
               it, the pinned snapshot still serves the expired keys), then
               ``extract_slice`` of 1/1024 of the key space, ``compact_chain``
               (nothing while the window still holds the slice's versions,
               the stubs once it has aged out) and ``ingest_slice`` back.
               Every answer is checked against the numpy oracle (expired
               keys dead) or its copy frozen at the snapshot; B1-B3 must run
               on the live filtered waves.  One filtered RANGE wave and an
               ``as_of`` GET and RANGE wave also run under ``torch.profiler``.
   frontend — the serving front end on phase 3's store (before the versioned
               phase): ``launch/serve.py``'s ``serve_kv`` loop (per 4 waves
               2 GET waves of 65536 zipf keys, an UPDATE of the first 16384
               of a draw, repeats included, a RANGE of 64 starts) through
               ``PipelinedStore`` at queue depth 1, then 2, 32 waves each;
               every answer against the oracle, B1-B3 launched in each run;
               requests/s, waves by kind, serial-path write waves, flush
               cycles, the ledger's issue and drain us per wave and overlap,
               and ``perfmodel.pipelined_wave_mops``; then 8 waves at depth
               2 under the pipeline's ``torch.profiler`` trace (wall,
               device ms and busy share, launches, the spans' CPU time).
   tenants  — the 4-tenant deployment of ``launch/serve.py`` (``--tenants 4
               --tenant-rate 0:2048 --tenant-weights 0:0.5 --max-delay 4``,
               1024-row waves) on phase 3's keys re-encoded into tenant
               slabs: 512 iterations of ``serve_kv_tenants``' request mix
               through ``KVWaveDriver``, every admitted reply against the
               oracle (RANGE rows clipped at the tenant's ceiling and
               decoded), no cross-tenant row, B1-B3 launched.
   sharded  — the replicated range tier on phase 3's 50M keys (after the
               tenants phase): ``launch/serve.py --partition range --shards
               4 --replication 2 --kill-primary-at 8 --rebalance
               --rebalance-every 4`` with the single store's hot cache, 16
               waves of 65536 through ``PipelinedStore(queue_depth=2)`` (2
               zipf GET waves, a storm of 16384 sequential fresh keys and a
               RANGE of 64 starts in every 4), shard 0's primary killed after
               wave 7 and rebuilt at wave 8, ``maybe_rebalance`` every 4
               waves (trigger scaled to 50M keys).  Every answer against the
               oracle, every acknowledged write read back from every in-sync
               replica, each group's replicas equal, the groups' pairs equal
               to the oracle's; B1-B3 launched.  Then ``stacked()`` (seconds,
               bytes), ``serve_wave_emulated`` on (4, 16384) requests at an
               ample cap and at one it overflows (RETRY rows, every other row
               equal to the oracle) and ``range_wave_emulated`` on (4, 16)
               starts (limit 10, fan-out 2), timed.
   dist     — right after ``sharded``, on its stack: 4 spawned ``gloo``
               ranks on the card (the pools as CUDA IPC handles, one shard
               each) run ``serve_wave_sharded`` and ``range_wave_sharded``
               on the same requests and caps, 3 times each; the gathered
               rows equal the emulated waves' bitwise, B1 and B3 launch in
               every rank; per wave each rank's host ms, exchange ms and
               bytes.
4. parity   — the same seeded op stream on a 200k-key store on the card and
               on the CPU: responses and final state tensors identical; then
               a second pair with a retention window (TTL puts, ticks, two
               snapshots, ``as_of`` reads and a bounded resume, the sweep,
               extract / compact / ingest, the write fast path).
               ``frontend-parity``: twin 1M-key stores on the card,
               ``serve_kv``'s script (32 waves of 8192) run serially and
               through ``PipelinedStore(queue_depth=2)`` with every ticket
               redeemed at the end: identical answers, ``items()`` and
               counters.  ``sharded-parity``: twin 600k-key facades on the
               card and on the CPU, the range tier (2 shards x R=2) and the
               hash tier (4 shards), one seeded stream each (GET, PUT,
               DELETE, RANGE with ``k_max``/``fanout``/one leaf a round, the
               issue and finalize halves, a bounded resume, a primary kill,
               retire and recovery, a rebalance with reads under both
               epochs, reshards 2 -> 4 -> 3, TTL puts and the sweep, chain
               compaction, ``as_of``, both emulated waves, a snapshot
               restored at another shard count): everything identical.
               ``dist-parity``: the range tier at 600k keys (4 shards)
               before and during a live rebalance, 4 ``gloo`` ranks on the
               card against the port's emulated waves on the CPU (hash and
               range routing, both epochs, mixed-epoch tags, RETRY caps,
               the looped RANGE); then an NCCL group of world size 1 on a
               1-shard hash tier, equal to the emulated wave and the GET.
               ``kv-dryrun``: ``python -m repro_torch.launch.kv_dryrun
               --mesh both``: one rank of the production 16-way ``data``
               axis (3,125,000 keys, 4096 requests, cap 4096) per mesh,
               answers against the shard's keys, bytes per device = 5
               exchanges of a (16, 4096) int32 tensor.
               ``serve-cli``: ``python -m repro_torch.launch.serve`` run as
               a user runs it, at 1M keys: ``--retain-epochs 64 --ttl 4``,
               the 4-tenant command and the four sharded commands (hash;
               range with ``--rebalance``; ``--replication 2
               --kill-primary-at 8``; ``--shards 2 --reshard-to 4
               --snapshot-dir``), each exit 0 with its report lines; the
               snapshot restores through ``restore_store`` at 3 shards with
               the snapshot's pairs as ``items()``.
5. paged    — the paged KV cache path at one llama3-405b attention layer's
               widths (128 query heads, 8 KV heads, head_dim 128, bf16 pools
               of 65536 blocks of 16 tokens: 4 GiB for K and V).  The page
               table is first bulk-loaded with other sequences' pages until
               87.5% of the pool is taken, as on a busy server.  8 sequences
               then run interleaved: a prompt of 128-512 tokens appended, then
               128-512 decode steps of one append and one ``attend`` each.
               Every attend is held against ``decode_attention`` on the dense
               K/V, slot lists against the slots the appends took; a release
               and a re-append into the freed blocks follow.  Kernels B1-B3
               are held bitwise against their plain versions on the page
               table's state at the path's 1-request shapes (GET and the
               probes also from a cold L2, with their plans).  Kernel B4
               must have run on the path, once per attend for K and V
               together; it is then held bitwise against its plain
               versions and timed, one pool and the K and V pair, warm and
               from a cold L2, beside ``index_select`` (once and twice), at
               three shapes: one sequence's slot list (fewer slots than SMs),
               1024 and 16384 random slots.  It is checked here and not in
               phase 2 because its first shape comes from this path.

Then the kernels' summary line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero without printing a result when CUDA is absent or when the
repository's ``src/repro_torch`` is not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_KEYS = 50_000_000  # dpastore_service.py:11 and the paper's Table-1 scale
WAVE = 65536  # requests per wave (dpastore_service.py:12)
ROUNDS = 6  # YCSB-B rounds: one GET wave + one UPDATE wave each
PARITY_KEYS = 200_000
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor-core 32-bit rate (data sheet, f32)
ZIPF = 0.99
# the paged phase: one attention layer of llama3-405b (configs/llama3_405b.py)
PAGED_HEADS, PAGED_KV_HEADS, PAGED_HEAD_DIM = 128, 8, 128
PAGED_BLOCK = 16  # PagedAttentionLayer's default block_size
PAGED_BLOCKS = 65536  # 1,048,576 token slots: 2 GiB per bf16 pool
PAGED_SEQS = 8
PAGED_PROMPT = (128, 512)  # prompt tokens per sequence, drawn from the seed
PAGED_DECODE = (128, 512)  # decode steps per sequence (one append + one attend)
PAGED_REAPPEND = 256  # tokens appended after two releases: fits their blocks
PAGED_BG_FILL = 0.875  # the pool share other sequences' pages hold
PAGED_BG_BLOCKS = (256, 768)  # their blocks each: 4k-12k tokens
GATHER_LONG = 1024  # B4 at a slot list longer than the card's 132 SMs
GATHER_RANDOM = 16384  # B4's largest shape: 512 MiB read and 512 MiB written per pool
L2_FLUSH_BYTES = 256 * 2**20  # written before each cold-L2 call: more than the 50 MB L2
ATTEND_TOL = 1e-4  # paged vs dense on the same bf16 K/V: f32 summation order only
# the versioned phase: launch/serve.py:29-33 (--retain-epochs 64 --ttl 4)
VERSIONED_RETAIN = 64
VERSIONED_TTL = 4
VERSIONED_GROWTH = 4.0  # TreeConfig()'s pool headroom, enough for the phase
VERSIONED_SLICE = 2**54  # extract_slice width: 1/1024 of the u64 key space
# the second parity pair: retention and headroom as in tests/test_versioned.py
PARITY_RETAIN, PARITY_GROWTH = 40, 64.0
NO_DEADLINE = np.iinfo(np.int64).max  # the oracle's deadline of a key without a TTL
# the front end: launch/serve.py's serve_kv loop at the service config's
# scale (dpastore_service.py: 50M keys, 65536-request waves), per depth
FRONTEND_WAVES = 32  # waves per queue depth: 2 GET, 1 UPDATE, 1 RANGE in every 4 (64 before the sharded phases)
FRONTEND_PROFILED = 8  # waves at depth 2 under torch.profiler
FRONTEND_RANGE = 64  # RANGE starts per wave (serve.py: q[:64], limit 10)
# frontend-parity: twin 1M-key stores over serve_kv's script with submit lag
FRONT_PARITY_KEYS, FRONT_PARITY_WAVES, FRONT_PARITY_WAVE = 1_000_000, 32, 8192
# the 4-tenant deployment of launch/serve.py:36-40 (--tenants 4 --tenant-rate
# 0:2048 --tenant-weights 0:0.5 --max-delay 4, --wave-size left at 1024)
TENANTS, TENANT_RATE, TENANT_WEIGHT0, TENANT_DELAY, TENANT_WAVE = 4, 2048.0, 0.5, 4, 1024
TENANT_ITERS = 512  # loop iterations of serve_kv_tenants' request mix, a drain every 4
CLI_KEYS = 1_000_000  # the serve-cli phase's stores
# the sharded deployment of src/repro/launch/serve.py:15-22 (--partition range --shards
# 4 --replication 2 --kill-primary-at 8, with --rebalance --rebalance-every 4)
SHARDS, REPLICAS = 4, 2
# serve_kv's loop: per 4 waves 2 GET, a fresh-insert storm, a RANGE.  Cut
# from 32 waves: each storm takes ~14 s (~1024 retry flush cycles on each
# replica, PERF.md section 6)
SHARDED_WAVES = 16
SHARDED_KILL_AT = 8  # shard 0's primary dies after wave 7; retire and recovery at wave 8
SHARDED_REBALANCE_EVERY = 4
# the planner's occupancy trigger scaled to 50M keys: the default 1.4 would
# need ~5M fresh keys on one shard, the loop writes 16384 a storm; 1.0025
# fires after 3 storms (49152 keys) and not after 2.  A 2^22-key reservoir
# keeps the refit's own sampling spread (~0.1 %) under the trigger
SHARDED_TRIGGER, SHARDED_SAMPLE = 1.0025, 1 << 22
SHARDED_EMU_W = 16384  # serve_wave_emulated: (4, 16384) requests
SHARDED_EMU_CAP_SMALL = 2048  # a per-(src, dest) cap the wave overflows
SHARDED_PARITY_GROWTH, SHARDED_PARITY_RETAIN = 16.0, 8  # headroom for retention, migration and reshards
# sharded-parity's keys: 600k keep every shard (150k-300k keys) at depth 3 through
# the stream's reshards; at 200k the 100k-key shards sit at the depth-2 limit
# (896 leaves), the storm's splits would deepen one of them, and stacked()
# refuses mixed depths, as the reference's does
SHARDED_PARITY_KEYS = 600_000
# the multi-rank waves: one gloo rank per shard, all on the one card (NCCL
# puts one rank on a card); each wave is timed DIST_REPS times in every rank
DIST_REPS = 3
DIST_PARITY_W = 256  # requests per rank in dist-parity's waves
DIST_PARITY_STORM = 3000  # sequential fresh keys past the last shard before its rebalance (as sharded-parity)
# kv-dryrun: 5 exchanges of a (16, 4096) int32 tensor per device and wave
KV_DRYRUN_BYTES = 5 * 16 * (65536 // 16) * 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _setup():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script measures the card only")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: src/repro_torch not found beside this script")
    sys.path.insert(0, str(src))
    return torch


_L2_FLUSH = []  # a buffer larger than the card's 50 MB L2, made at first use


def time_ms(torch, fn, reps: int = 25, warm: int = 3, cold: bool = False) -> float:
    """Median device time of one call (CUDA events), after warm-up.  Each
    call is queued behind a ~20 ms device sleep, so the host has enqueued
    every launch of the call before the first event fires: the time is the
    device's, not the host's launch overhead.  ``cold``: before each call,
    256 MB are written, so that the call finds none of its data in the L2."""
    if cold and not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda"))
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if cold:
            _L2_FLUSH[0].fill_(len(times))
        torch.cuda._sleep(40_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------- oracle


class Oracle:
    """Sorted keys and values with the acknowledged writes applied, and the
    TTL deadlines of a logical clock (a key at or past its deadline is
    dead)."""

    def __init__(self, keys, vals):
        self.keys = keys
        self.vals = vals.copy()
        self.alive = np.ones(keys.size, dtype=bool)
        self.deadline = None  # per key, made at the first TTL write
        self.now = 0

    def pos(self, ks):
        p = np.searchsorted(self.keys, ks)
        assert (self.keys[p] == ks).all(), "oracle tracks updates of existing keys only"
        return p

    def put(self, ks, vs, ttl=None):
        p = self.pos(ks)
        self.vals[p] = vs  # duplicates: the last write wins, as in the store
        self.alive[p] = True
        if ttl is not None and self.deadline is None:
            self.deadline = np.full(self.keys.size, NO_DEADLINE, dtype=np.int64)
        if self.deadline is not None:  # a write without ttl clears the deadline
            self.deadline[p] = NO_DEADLINE if ttl is None else self.now + ttl

    def delete(self, ks):
        p = self.pos(ks)
        self.alive[p] = False
        if self.deadline is not None:
            self.deadline[p] = NO_DEADLINE

    def expired(self):
        if self.deadline is None:
            return np.zeros(self.keys.size, dtype=bool)
        return self.deadline <= self.now

    def live(self):
        return self.alive & ~self.expired()

    def frozen(self):
        """A copy of what reads see now, for ``as_of`` reads of this state."""
        o = Oracle(self.keys, self.vals)
        o.alive = self.live()
        return o

    def check_get(self, ks, vals, found):
        p = np.minimum(np.searchsorted(self.keys, ks), self.keys.size - 1)
        exp_f = (self.keys[p] == ks) & self.live()[p]
        exp_v = np.where(exp_f, self.vals[p], 0)
        assert (found == exp_f).all(), f"GET found: {int((found != exp_f).sum())} rows differ"
        assert (vals == exp_v).all(), f"GET vals: {int((vals != exp_v).sum())} rows differ"

    def expect_range(self, starts, limit):
        """(keys, vals, counts) of RANGE(starts, limit) on this state."""
        idx = np.flatnonzero(self.live())
        ak, av = self.keys[idx], self.vals[idx]
        j = np.searchsorted(ak, starts)
        cols = j[:, None] + np.arange(limit)[None, :]
        ok = cols < ak.size
        cols = np.minimum(cols, ak.size - 1)
        return np.where(ok, ak[cols], 0), np.where(ok, av[cols], 0), ok.sum(axis=1)

    def check_range(self, starts, limit, res):
        keys, vals, counts = self.expect_range(starts, limit)
        assert (res.counts == counts).all(), "RANGE counts differ"
        assert (res.keys == keys).all(), "RANGE keys differ"
        assert (res.vals == vals).all(), "RANGE vals differ"


# ------------------------------------------------------- bytes and bounds


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _uniq(torch, x) -> int:
    return int(torch.unique(x).numel())


def _window_bytes(torch, slot, lo, count, w) -> int:
    """Distinct 8-byte keys the requests' search windows touch."""
    pos = lo[:, None] + torch.arange(w, device=lo.device)[None, :]
    return 8 * _uniq(torch, (slot[:, None] * 128 + pos)[pos < count[:, None]])


def get_bytes_ops(torch, lookup, keys_mod, st, khi, klo):
    """Distinct bytes GET reads and writes on this data, each once (see
    csrc/traverse.cu for the per-request list), and its compares.  Lanes
    that share a node, window or insert buffer share its bytes."""
    t, ib, cfg = st.tree, st.ib, st.cfg
    kh, kl = keys_mod.u32(khi), keys_mod.u32(klo)
    B = khi.shape[0]
    w_in, w_lf = 2 * cfg.eps_inner + 2, 2 * cfg.eps_leaf + 2
    nbytes = B * (8 + 9) + 4  # request keys in, value + flag out, root id
    node = t.root.long().expand(B)
    for _ in range(st.depth - 1):  # the descent of lookup._route, instrumented
        sf = keys_mod.u32(t.node_seg_first[node])
        seg = keys_mod.limb_le(sf[:, 1:, 0], sf[:, 1:, 1], kh[:, None], kl[:, None]).sum(1)
        bidx = torch.arange(B, device=node.device)
        pred = lookup._predict(t.node_seg_slope[node, seg], sf[bidx, seg, 0], sf[bidx, seg, 1], kh, kl)
        count = t.node_seg_count[node, seg].long()
        slot = t.node_seg_slot[node, seg].long()
        rank, lo = lookup._window_rank(t.pivot_keys, slot, count, pred, cfg.eps_inner, kh, kl)
        rank = torch.clamp(rank, min=0)
        nbytes += 56 * _uniq(torch, node) + 12 * _uniq(torch, node * 7 + seg)
        nbytes += _window_bytes(torch, slot, lo, count, w_in) + 4 * _uniq(torch, slot * 128 + rank)
        node = t.pivot_child[slot, rank].long()
    leaf = node
    slot, count = t.leaf_slot[leaf].long(), t.leaf_count[leaf].long()
    anchor = keys_mod.u32(t.leaf_anchor[leaf])
    pred = lookup._predict(t.leaf_slope[leaf], anchor[:, 0], anchor[:, 1], kh, kl)
    rank, lo = lookup._window_rank(t.hbm_keys, slot, count, pred, cfg.eps_leaf, kh, kl)
    present, deleted = lookup.ib_search(ib, leaf, khi, klo)[:2]
    ul = torch.unique(leaf)
    nbytes += 20 * ul.numel() + _window_bytes(torch, slot, lo, count, w_lf)
    nbytes += 4 * ul.numel() + 12 * int(ib.count[ul].sum())  # buffer count, ops, keys
    tree_val = (rank >= 0) & ~present & ~deleted
    nbytes += 8 * _uniq(torch, (slot * 128 + rank)[tree_val]) + 8 * _uniq(torch, (kh * 2**32 + kl)[present])
    nops = B * ((6 + w_in) * (st.depth - 1) + w_lf + 24) + 3 * int(ib.count[leaf].sum())
    return nbytes, nops


def probe_bytes_ops(torch, cacheset, keys_mod, cache, tid, khi, klo, cfg, salts, bucket_salt, P):
    """Distinct bytes the probe reads and writes: the requests and their
    outputs, the Bloom words they test, for Bloom-positive requests their
    buckets' keys and flags, and for hits the matching way's payload."""
    kh, kl = keys_mod.u32(khi), keys_mod.u32(klo)
    t = tid.long()
    B = khi.shape[0]
    may = cacheset.bloom_may(cache.bloom, t, kh, kl, cfg.bloom_bits, salts)
    n_words = cache.bloom.shape[1]
    words = torch.cat([t * n_words + h // 32 for h in cacheset.bloom_hashes(kh, kl, cfg.bloom_bits, salts)])
    b = cacheset.bucket_of(kh, kl, cfg.n_buckets, bucket_salt)
    bucket = t * cfg.n_buckets + b
    bk = keys_mod.u32(cache.bkey[t, b])
    eq = keys_mod.limb_eq(bk[:, :, 0], bk[:, :, 1], kh[:, None], kl[:, None]) & cache.bvalid[t, b]
    hit = may & eq.any(dim=1)
    entry = bucket * cfg.ways + torch.argmax(eq.to(torch.int32), dim=1)
    nbytes = B * (12 + 1 + 4 * P) + 4 * _uniq(torch, words) + cfg.ways * 9 * _uniq(torch, bucket[may])
    nbytes += 4 * P * _uniq(torch, entry[hit])
    nops = B * 4 * 20 + int(may.sum()) * cfg.ways * 4
    return nbytes, nops


def walk_bytes_ops(torch, tree, visited, L, max_leaves):
    """Distinct bytes the walk reads and writes: each visited leaf's next,
    count and slot and its live keys and values once, the requests, and
    the outputs."""
    B = visited.shape[0]
    live = torch.unique(visited[visited >= 0].long())
    counts = int(tree.leaf_count[live].long().sum())
    nbytes = B * 12 + 12 * live.numel() + 16 * counts + B * (16 * L + 8 + 4 * max_leaves)
    nops = 6 * int(tree.leaf_count[visited[visited >= 0].long()].long().sum()) + B * max_leaves * 16
    return nbytes, nops


def get_plan(torch, st, B: int) -> dict:
    """The launch plan kernel B1 takes for a wave of ``B`` requests on ``st``."""
    from repro_torch.kernels import build, traverse

    plan = traverse.get_plan(B, st.cfg.eps_inner, st.cfg.eps_leaf,
                             build.sm_count(torch.cuda.current_device()), traverse._ctas_per_sm)
    return plan._asdict()


def probe_wave(torch, st, q, P: int) -> dict:
    """The plan kernel B2 takes for the probe wave of keys ``q`` on ``st``'s
    hot-entry (P=2) or scan-anchor (P=1) cache, and the wave's
    Bloom-positive share."""
    from repro_torch.core import cacheset, hotcache, scancache
    from repro_torch.core.keys import u32
    from repro_torch.kernels import build, cache_probe

    if P == 2:
        cache, bpay, cfg, salts = st.cache, st.cache.bval, st.cache_cfg, hotcache.SALT_BLOOM
    else:
        cache, bpay, cfg, salts = st.scan_cache, st.scan_cache.bleaf[..., None], st.scan_cache_cfg, scancache.SALT_SBLOOM
    khi, klo = st._limbs(q)
    tid = hotcache.steer(khi, klo, cfg.n_threads)
    may = cacheset.bloom_may(cache.bloom, tid, u32(khi), u32(klo), cfg.bloom_bits, salts)
    aligned = cache_probe.vector_aligned(cache.bkey, bpay, cache.bvalid)
    plan = cache_probe.probe_plan(q.size, cfg.ways, P, aligned, build.sm_count(torch.cuda.current_device()))
    return {"plan": plan._asdict(), "bloom_positive": float(may.float().mean())}


def inner_nodes_per_level(img) -> list:
    """Inner nodes of the host tree image per level, root first."""
    levels = [[img.root]] if img.depth > 1 else []
    while levels and len(levels) < img.depth - 1:
        nxt = []
        for node in levels[-1]:
            for s in range(int(img.node_nseg[node])):
                nxt += img.pivot_child[img.node_seg_slot[node, s], : img.node_seg_count[node, s]].tolist()
        levels.append(nxt)
    return [len(level) for level in levels]


# ------------------------------------------------- kernels B1-B3 on a store


def kernel_cases(torch, st, q, L: int, ML: int):
    """Kernels B1-B3 and their plain versions on store ``st``'s state for the
    request keys ``q`` (a walk of limit ``L`` over ``ML`` leaves from the
    keys' start leaves): name -> (kernel call, plain call, source, the TPU
    kernel it replaces, bytes-and-operations of this run's inputs)."""
    from repro_torch.core import cacheset, hotcache, lookup, scancache
    from repro_torch.core import keys as keys_mod
    from repro_torch.kernels import cache_probe, range_scan, traverse

    khi, klo = st._limbs(q)
    kw = dict(depth=st.depth, eps_inner=st.cfg.eps_inner, eps_leaf=st.cfg.eps_leaf)
    ccfg, scfg = st.cache_cfg, st.scan_cache_cfg
    tid = hotcache.steer(khi, klo, ccfg.n_threads)
    stid = hotcache.steer(khi, klo, scfg.n_threads)
    c, sc = st.cache, st.scan_cache
    pk2 = dict(bloom_bits=ccfg.bloom_bits, n_buckets=ccfg.n_buckets,
               salts_bloom=hotcache.SALT_BLOOM, salt_bucket=hotcache.SALT_BUCKET)
    pk1 = dict(bloom_bits=scfg.bloom_bits, n_buckets=scfg.n_buckets,
               salts_bloom=scancache.SALT_SBLOOM, salt_bucket=scancache.SALT_SBUCKET)
    sbleaf = sc.bleaf[..., None]
    start = lookup.traverse(st.tree, khi, klo, depth=st.depth, eps_inner=st.cfg.eps_inner)
    return {
        "get": (
            lambda: traverse.get_cuda(st.tree, st.ib, khi, klo, **kw),
            lambda: traverse.get_plain(st.tree, st.ib, khi, klo, **kw),
            "src/repro_torch/csrc/traverse.cu", "src/repro/kernels/traverse.py:59",
            lambda got: get_bytes_ops(torch, lookup, keys_mod, st, khi, klo),
        ),
        "cache_probe_p2": (
            lambda: cache_probe.probe_cuda(c.bloom, c.bkey, c.bval, c.bvalid, tid, khi, klo, **pk2),
            lambda: cache_probe.probe_plain(c.bloom, c.bkey, c.bval, c.bvalid, tid, khi, klo, **pk2),
            "src/repro_torch/csrc/cache_probe.cu", "src/repro/kernels/cache_probe.py:51",
            lambda got: probe_bytes_ops(torch, cacheset, keys_mod, c, tid, khi, klo, ccfg,
                                        hotcache.SALT_BLOOM, hotcache.SALT_BUCKET, 2),
        ),
        "cache_probe_p1": (
            lambda: cache_probe.probe_cuda(sc.bloom, sc.bkey, sbleaf, sc.bvalid, stid, khi, klo, **pk1),
            lambda: cache_probe.probe_plain(sc.bloom, sc.bkey, sbleaf, sc.bvalid, stid, khi, klo, **pk1),
            "src/repro_torch/csrc/cache_probe.cu", "src/repro/kernels/cache_probe.py:51",
            lambda got: probe_bytes_ops(torch, cacheset, keys_mod, sc, stid, khi, klo, scfg,
                                        scancache.SALT_SBLOOM, scancache.SALT_SBUCKET, 1),
        ),
        "range_walk": (
            lambda: range_scan.walk_cuda(st.tree, start, khi, klo, limit=L, max_leaves=ML),
            lambda: range_scan.walk_plain(st.tree, start, khi, klo, limit=L, max_leaves=ML),
            "src/repro_torch/csrc/range_scan.cu", "src/repro/kernels/range_scan.py:29",
            lambda got: walk_bytes_ops(torch, st.tree, got[5], L, ML),
        ),
    }


def max_abs_err(torch, name: str, got, want) -> float:
    """Every output of B1-B3 is an integer or a flag: the tolerance is 0."""
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        diff = (a.to(torch.float64) - b.to(torch.float64)).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
    if err != 0.0:
        raise AssertionError(f"kernel {name} disagrees with its plain version ({err})")
    return err


def profile_wave(torch, op: str, requests: int, run) -> None:
    """One wave under ``torch.profiler``: its wall time, the device time and
    busy share, the device launches and the six kernels that took longest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    emit({
        "phase": "profile", "op": op, "requests": requests, "wall_ms_profiled": wall_ms,
        "device_ms": dev_ms, "device_busy": dev_ms / wall_ms,
        "device_launches": sum(e.count for e in ev),
        "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count] for e in top],
    })


# ------------------------------------------------------- card == CPU


def _same(results, what):
    """The card's and the CPU's answers to one call are identical."""
    a, b = results
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            assert np.array_equal(x, y), what
    elif hasattr(a, "counts"):
        for f in ("keys", "vals", "counts", "truncated", "cursor_leaf", "cursor_key"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f"{what}: {f}"
        assert a.rounds == b.rounds and a.stats == b.stats, what
    else:
        assert np.array_equal(a, b), what


def _same_state(a, b):
    """Stats, TTL sidecar, version chain and every device tensor identical."""
    from repro_torch.core import carry

    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats), "stats"
    assert a.ttl == b.ttl and a._ttl_snaps == b._ttl_snaps and a.epochs.cycle == b.epochs.cycle, "ttl, epochs"
    assert np.array_equal(a.image.ver_birth, b.image.ver_birth) and np.array_equal(a.image.ver_prev, b.image.ver_prev)
    for to_np, fa, fb in (
        (carry.tree_to_numpy, a.tree, b.tree),
        (carry.ib_to_numpy, a.ib, b.ib),
        (carry.cache_to_numpy, a.cache, b.cache),
        (carry.scan_cache_to_numpy, a.scan_cache, b.scan_cache),
    ):
        xa, xb = to_np(fa), to_np(fb)
        for f in xa:
            assert np.array_equal(xa[f], xb[f]), f"state {f}"


def versioned_parity(torch, dev) -> None:
    """Phase 4, second pair: a 200k-key store with a retention window on the
    card and on the CPU, driven through TTL puts, ticks, two snapshots,
    ``as_of`` reads and a bounded resume, the sweep, extract / compact /
    ingest and the write fast path.  Everything must be identical."""
    from repro_torch.core import DPAStore, TreeConfig, datasets

    t_pair = time.perf_counter()
    pkeys = datasets.sparse(PARITY_KEYS, seed=SEED + 6)
    pvals = pkeys ^ np.uint64(0x77)
    stores = [DPAStore(pkeys, pvals, TreeConfig(growth=PARITY_GROWTH), retain_epochs=PARITY_RETAIN, device=d)
              for d in (dev, "cpu")]
    prng = np.random.default_rng(SEED + 7)
    pz = pkeys[datasets.zipf_indices(pkeys.size, 60_000, alpha=ZIPF, seed=SEED + 8)]
    ttl_keys = prng.choice(pkeys, 3000, replace=False)
    _same([s.put(ttl_keys, ttl_keys ^ np.uint64(3), ttl=3) for s in stores], "ttl put")
    snaps = [[s.snapshot_epoch() for s in stores]]
    fast = slow = 0
    for step in range(4):
        q = np.concatenate([prng.choice(pz, 2048), prng.choice(ttl_keys, 512)])
        _same([s.get(q) for s in stores], f"get {step}")
        for e in snaps:
            _same([s.get(q, as_of=e[0]) for s in stores], f"get as_of {step}")
        upd = np.unique(prng.choice(pz, 1000))  # distinct: repeats would burn the window in retries
        _same([s.put(upd, upd ^ np.uint64(step + 1), ttl=2 if step % 2 else None) for s in stores], f"put {step}")
        dels = prng.choice(pkeys, 300)
        _same([s.delete(dels) for s in stores], f"delete {step}")
        for op, ks in (("put", prng.choice(pkeys, 64)), ("delete", prng.choice(pkeys, 64)), ("put", prng.choice(pz, 600))):
            ws = [s.write_issue(op, ks, ks ^ np.uint64(9) if op == "put" else None) for s in stores]
            assert (ws[0] is None) == (ws[1] is None), f"write plan {step}"
            if ws[0] is None:
                slow += 1
                _same([s.put(ks, ks ^ np.uint64(9)) if op == "put" else s.delete(ks) for s in stores],
                      f"serial {op} {step}")
            else:
                fast += 1
                _same([s.write_finalize(w) for s, w in zip(stores, ws)], f"fast {op} {step}")
        for s in stores:
            s.ttl.tick(1)
        starts = prng.choice(pz, 1024)
        _same([s.range(starts, limit=10) for s in stores], f"range {step}")
        for e in snaps:
            _same([s.range(starts, limit=10, as_of=e[0]) for s in stores], f"range as_of {step}")
            rs = [s.range_with_state(starts[:256], limit=30, max_leaves=1, max_rounds=1, as_of=e[0]) for s in stores]
            _same(rs, f"bounded as_of {step}")
            m = rs[0].truncated
            if m.any():
                _same([s.range_with_state(starts[:256][m], limit=30, max_leaves=1, start_leaves=r.cursor_leaf[m],
                                          as_of=e[0]) for s, r in zip(stores, rs)], f"resumed as_of {step}")
        if step == 1:
            snaps.append([s.snapshot_epoch() for s in stores])
            assert snaps[-1][0] == snaps[-1][1]
    _same([np.array([s.ttl_sweep()]) for s in stores], "ttl_sweep")
    for e in snaps:
        _same([s.get(ttl_keys, as_of=e[0]) for s in stores], "get as_of after the sweep")
    k_lo, k_hi = pkeys[PARITY_KEYS // 3], pkeys[PARITY_KEYS // 3 + PARITY_KEYS // 50]
    _same([np.array([s.count_slice(k_lo, k_hi)]) for s in stores], "count_slice")
    xs = [s.extract_slice(k_lo, k_hi) for s in stores]
    _same(xs, "extract_slice")
    _same([np.array([s.compact_chain(), s.stub_count()]) for s in stores], "compact in the window")
    for i in range(PARITY_RETAIN):  # age the window past the extract
        for s in stores:
            s.put(pkeys[i : i + 1], pkeys[i : i + 1])
            s.flush()
    _same([np.array([s.compact_chain(), s.stub_count(), s.live_count()]) for s in stores], "compact")
    _same([np.array([s.ingest_slice(*x)]) for s, x in zip(stores, xs)], "ingest_slice")
    _same([s.items() for s in stores], "items")
    a, b = stores
    _same_state(a, b)
    assert fast and slow, "both write paths must run"
    assert a.stats.stub_leaves_compacted > 0 and a.stats.migrated_in_keys == xs[0][0].size > 0
    emit({"phase": "parity", "keys": PARITY_KEYS, "retain_epochs": PARITY_RETAIN, "growth": PARITY_GROWTH,
          "identical": True, "snapshots": [e[0] for e in snaps], "cycles": a.epochs.cycle,
          "fast_writes": fast, "serial_writes": slow, "slice_keys": int(xs[0][0].size),
          "stubs_compacted": a.stats.stub_leaves_compacted, "flush_cycles": a.stats.flush_cycles,
          "stitch_applies": a.stats.stitch_applies, "seconds": time.perf_counter() - t_pair})


# ------------------------------------------------------- versioned phase


def versioned_phase(torch, dev, keys, vals) -> None:
    """The retention and TTL deployment on phase 3's keys: see the module
    docstring.  Raises on any mismatch."""
    from repro_torch.core import DPAStore, EpochRetiredError, TreeConfig, datasets
    from repro_torch.kernels import build

    W = WAVE
    n_upd = max(1, round(W * 5 / 95))
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = DPAStore(keys, vals, TreeConfig(growth=VERSIONED_GROWTH), retain_epochs=VERSIONED_RETAIN, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    oracle = Oracle(keys, vals)
    rng = np.random.default_rng(SEED + 5)
    zipf = keys[datasets.zipf_indices(keys.size, 18 * W + 12 * n_upd, alpha=ZIPF, seed=SEED + 5)]
    zpos = 0

    def draw(n):
        nonlocal zpos
        zpos += n
        assert zpos <= zipf.size, "draw budget exceeded"
        return zipf[zpos - n : zpos]

    timed = {}  # name -> [requests, seconds]

    def clock(name, n, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        acc = timed.setdefault(name, [0, 0.0])
        acc[0] += n
        acc[1] += time.perf_counter() - t
        return out

    def distinct(n):
        """The first ``n`` distinct keys of the next ``2n`` draws: an UPDATE
        wave writes each key once (a client coalesces a wave's writes to
        one key; the last would win anyway).  With repeats, the hottest
        key's ~170 writes a wave would take ~11 auto-retry flush cycles,
        and six rounds would outrun the 64-cycle window before the reads."""
        ks = draw(2 * n)
        _, first = np.unique(ks, return_index=True)
        assert first.size >= n, "too few distinct keys drawn"
        return ks[np.sort(first)[:n]]

    def tick(n):
        st.ttl.tick(n)
        oracle.now += n

    launches = {}
    snap0 = st.snapshot_epoch()
    frozen0 = oracle.frozen()

    # -- live waves: 6 rounds of GET + TTL UPDATE; the filter applies from
    # the second GET on, and the launches are counted from there
    for r in range(ROUNDS):
        if r == 1:
            build.reset_launches()
        q = draw(W)
        v, f = clock("get_live" if r else "get_unfiltered", W, lambda: st.get(q))
        oracle.check_get(q, v, f)
        ks = distinct(n_upd)
        vs = rng.integers(0, 2**64, ks.size, dtype=np.uint64)
        assert (st.put(ks, vs, ttl=VERSIONED_TTL) == 0).all()
        oracle.put(ks, vs, ttl=VERSIONED_TTL)
        tick(1)
        if r == 2:
            snap1 = st.snapshot_epoch()
            frozen1 = oracle.frozen()
    assert oracle.expired().any(), "the first rounds' TTL keys must have expired by now"
    starts = draw(W)
    res = clock("range_live", W, lambda: st.range(starts, limit=10))
    oracle.check_range(starts, 10, res)
    assert res.stats.get("ttl_filtered") == 1, "the live RANGE must run the TTL filter"
    launches["live"] = dict(build.launches)
    for k in ("get", "cache_probe_p2", "cache_probe_p1", "range_walk"):
        assert launches["live"][k] > 0, f"kernel {k} was not launched on the TTL-filtered waves"

    # -- point-in-time reads at both snapshots, and a bounded resume
    build.reset_launches()
    resolve_ms = []
    for _ in range(5):
        t = time.perf_counter()
        st._resolve_table(snap0)
        torch.cuda.synchronize()
        resolve_ms.append((time.perf_counter() - t) * 1e3)
    for snap, frozen, tag in ((snap0, frozen0, "0"), (snap1, frozen1, "1")):
        q = draw(W)
        v, f = clock("get_as_of" + tag, W, lambda: st.get(q, as_of=snap))
        frozen.check_get(q, v, f)
        starts = draw(W)
        res = clock("range_as_of" + tag, W, lambda: st.range(starts, limit=10, as_of=snap))
        frozen.check_range(starts, 10, res)
        assert res.stats["as_of"] == snap
    sub = draw(4096)
    a = st.range_with_state(sub, limit=10, max_leaves=1, max_rounds=1, as_of=snap0)
    ek, ev, ec = frozen0.expect_range(sub, 10)
    cols = np.arange(10)[None, :] < a.counts[:, None]
    assert (np.where(cols, ek, 0) == a.keys).all() and (np.where(cols, ev, 0) == a.vals).all(), "bounded as_of rows"
    m = a.truncated
    assert m.any() and (a.counts[m] < ec[m]).all(), "max_rounds=1 must leave rows truncated"
    k2 = np.where(a.counts[m] > 0, a.cursor_key[m] + np.uint64(1), sub[m])
    b = st.range_with_state(k2, limit=10, max_leaves=1, start_leaves=a.cursor_leaf[m], as_of=snap0)
    for i, row in enumerate(np.flatnonzero(m)):
        c = int(a.counts[row])
        got = np.concatenate([a.keys[row, :c], b.keys[i, : b.counts[i]]])[:10]
        assert got.size == ec[row] and (got == ek[row, : ec[row]]).all(), "resumed as_of row"
    launches["as_of"] = dict(build.launches)
    # where the time of the filtered and the as_of waves goes
    profile_wave(torch, "range_ttl", W, lambda: st.range(draw(W), limit=10))
    profile_wave(torch, "get_as_of", W, lambda: st.get(draw(W), as_of=snap0))
    profile_wave(torch, "range_as_of", W, lambda: st.range(draw(W), limit=10, as_of=snap0))

    # -- expiry: filtered reads, the sweep, the same reads again
    tick(VERSIONED_TTL)
    n_expired = int(oracle.expired().sum())
    qx = np.concatenate([draw(W // 2), keys[np.flatnonzero(oracle.expired())[: W // 2]]])
    build.reset_launches()
    pre = clock("get_live", qx.size, lambda: st.get(qx))
    oracle.check_get(qx, *pre)
    sx = draw(W)
    pre_r = clock("range_live", W, lambda: st.range(sx, limit=10))
    oracle.check_range(sx, 10, pre_r)
    launches["expired"] = dict(build.launches)
    build.reset_launches()
    t = time.perf_counter()
    reclaimed = st.ttl_sweep()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t
    assert reclaimed == n_expired, f"ttl_sweep reclaimed {reclaimed}, {n_expired} expired"
    oracle.alive &= ~oracle.expired()
    sweep_compacted = st.stats.stub_leaves_compacted
    post = st.get(qx)
    post_r = st.range(sx, limit=10)
    assert all((x == y).all() for x, y in zip(pre, post)), "GET after the sweep != the filtered GET before it"
    for f in ("keys", "vals", "counts"):
        assert (getattr(pre_r, f) == getattr(post_r, f)).all(), f"RANGE {f} after the sweep"
    v, f = st.get(qx, as_of=snap0)  # the pinned snapshot still serves the expired keys
    frozen0.check_get(qx, v, f)
    assert f[W // 2 :].all(), "snap0 must still serve the expired keys"
    launches["sweep"] = dict(build.launches)

    # -- slice migration: extract 1/1024 of the key space, compact, ingest
    build.reset_launches()
    k_lo = np.uint64(int(rng.integers(1, 1023)) * VERSIONED_SLICE)
    k_hi = k_lo + np.uint64(VERSIONED_SLICE)
    st.flush()
    in_slice = (keys >= k_lo) & (keys < k_hi) & oracle.live()
    assert st.count_slice(k_lo, k_hi) == int(in_slice.sum()), "count_slice"
    t = time.perf_counter()
    xk, xv = st.extract_slice(k_lo, k_hi)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t
    assert xk.size == int(in_slice.sum()) > 0, "extracted keys"
    assert (xk == keys[in_slice]).all() and (xv == oracle.vals[in_slice]).all(), "extracted pairs"
    oracle.delete(xk)
    stubs = st.stub_count()
    t = time.perf_counter()
    held = st.compact_chain()  # the window still holds the slice's versions
    compact_held_s = time.perf_counter() - t
    assert held == 0 and st.stub_count() == stubs, "compaction inside the retention window"
    cycle_extract = st.epochs.cycle
    for i in range(VERSIONED_RETAIN):  # age the window past the extract: one write and flush per cycle
        k = keys[np.flatnonzero(oracle.live())[i : i + 1]]
        st.put(k, k)
        oracle.put(k, k)
        st.flush()
    t = time.perf_counter()
    compacted = st.compact_chain()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t
    assert compacted > 0 and st.stub_count() < stubs, "stub_count must fall once the window has aged out"
    try:
        st.get(qx[:4], as_of=snap0)
    except EpochRetiredError:
        pass
    else:
        raise AssertionError("snap0 must be retired once the window has aged out")
    t = time.perf_counter()
    assert st.ingest_slice(xk, xv) == xk.size
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t
    oracle.put(xk, xv)
    assert st.count_slice(k_lo, k_hi) == xk.size, "count_slice after ingest"
    q = np.concatenate([xk[:: max(1, xk.size // 4096)], draw(W // 2)])
    oracle.check_get(q, *st.get(q))
    starts = np.concatenate([xk[:: max(1, xk.size // 2048)], draw(W // 2)])
    oracle.check_range(starts, 10, st.range(starts, limit=10))
    launches["migration"] = dict(build.launches)
    stats = st.stats
    # batched cycles: one apply per flush cycle, and one per compaction that removed stubs
    assert stats.flush_cycles + int(sweep_compacted > 0) + 1 == stats.stitch_applies, "applies per cycle"
    emit({
        "phase": "versioned", "keys": int(keys.size), "wave": W, "retain_epochs": VERSIONED_RETAIN,
        "ttl": VERSIONED_TTL, "growth": VERSIONED_GROWTH, "store_build_s": build_s,
        "leaves_pool": int(st.tree.leaf_count.shape[0]), "depth": st.depth,
        "snapshots": [snap0, snap1], "cycles": st.epochs.cycle, "cycles_at_extract": cycle_extract,
        **{f"{k}_mops": n / sec / 1e6 for k, (n, sec) in timed.items()},
        "requests": {k: n for k, (n, _) in timed.items()},
        "resolve_table_ms_median": float(np.median(resolve_ms)), "resolve_table_ms": resolve_ms,
        "ttl_sweep_s": sweep_s, "keys_expired": n_expired, "keys_reclaimed": reclaimed,
        "slice": [int(k_lo), int(k_hi)], "slice_keys": int(xk.size), "extract_slice_s": extract_s,
        "stubs_after_extract": stubs, "compact_in_window_s": compact_held_s, "compact_chain_s": compact_s,
        "stubs_compacted": compacted, "stubs_after": st.stub_count(), "ingest_slice_s": ingest_s,
        "launches": launches, "flush_cycles": stats.flush_cycles, "stitch_applies": stats.stitch_applies,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "oracle": "all live, as_of, swept and migrated answers equal",
        "seconds": time.perf_counter() - t_phase,
    })
    del st, oracle, frozen0, frozen1, zipf
    torch.cuda.empty_cache()


# ------------------------------------------------------ serving front end


class _LiveRows:
    """The front end's answers from the oracle, whose live rows are taken
    again only when a write revives a deleted key (the front end deletes
    nothing and sets no TTL, so ``alive`` is what reads see)."""

    def __init__(self, oracle):
        assert oracle.deadline is None, "the front end's oracle carries no TTL"
        self.oracle = oracle
        self.idx = np.flatnonzero(oracle.alive)
        self.keys = oracle.keys[self.idx]

    def put(self, ks, vs):
        revived = not self.oracle.alive[self.oracle.pos(ks)].all()
        self.oracle.put(ks, vs)  # duplicates carry one value: any order wins the same
        if revived:
            self.__init__(self.oracle)

    def expect_get(self, q):
        o = self.oracle
        p = np.minimum(np.searchsorted(o.keys, q), o.keys.size - 1)
        f = (o.keys[p] == q) & o.alive[p]
        return np.where(f, o.vals[p], 0), f

    def expect_range(self, starts, limit):
        cols = np.searchsorted(self.keys, starts)[:, None] + np.arange(limit)[None, :]
        ok = cols < self.keys.size
        c = np.minimum(cols, self.keys.size - 1)
        return np.where(ok, self.keys[c], 0), np.where(ok, self.oracle.vals[self.idx[c]], 0), ok.sum(axis=1)


def _front_script(live, draws, w0, n):
    """``serve_kv``'s waves ``w0 .. w0+n`` (2 GET, 1 UPDATE of the first
    quarter, repeats included, 1 RANGE of 64 starts in every 4) with the
    answers the oracle expects, the UPDATEs applied in order."""
    script = []
    for w in range(w0, w0 + n):
        q = draws[w * WAVE : (w + 1) * WAVE]
        if w % 4 < 2:
            script.append(("get", q, live.expect_get(q)))
        elif w % 4 == 2:
            upd = q[: WAVE // 4]
            live.put(upd, upd)
            script.append(("put", upd, None))
        else:
            starts = q[:FRONTEND_RANGE]
            script.append(("range", starts, live.expect_range(starts, 10)))
    return script


def _front_drive(pipe, script):
    """Submit the script through ``pipe`` and redeem as ``serve_kv`` does
    (all but ``queue_depth - 1`` tickets, in order).  Returns the results
    and the write waves that took the serial path."""
    results, pending, serial = [], [], 0
    for op, q, _ in script:
        if op == "get":
            t = pipe.submit_get(q)
        elif op == "put":
            t = pipe.submit_put(q, q)
            serial += t.ctx[0] == "serial"  # the ticket is in flight: its context is live
        else:
            t = pipe.submit_range(q, 10, max_leaves=4)
        pending.append(t)
        while len(pending) > pipe.queue_depth - 1:
            results.append(pipe.result(pending.pop(0)))
    while pending:
        results.append(pipe.result(pending.pop(0)))
    return results, serial


def _front_check(script, results, what):
    for i, ((op, q, want), got) in enumerate(zip(script, results, strict=True)):
        if op == "get":
            assert (got[1] == want[1]).all() and (got[0] == want[0]).all(), f"{what}: GET wave {i}"
        elif op == "put":
            assert (got == 0).all(), f"{what}: UPDATE wave {i} statuses"
        else:
            for f, x in zip(("keys", "vals", "counts"), want):
                assert (getattr(got, f) == x).all(), f"{what}: RANGE wave {i} {f}"


def frontend_phase(torch, st, oracle, keys) -> None:
    """The serving front end on phase 3's store: ``serve_kv``'s loop through
    ``PipelinedStore`` at queue depths 1 and 2, every answer against the
    oracle, B1-B3 launched in each run; then ``FRONTEND_PROFILED`` waves at
    depth 2 under the pipeline's ``torch.profiler`` trace."""
    import tempfile

    from repro_torch.core import datasets, perfmodel
    from repro_torch.kernels import build
    from repro_torch.serving.pipeline import PipelinedStore

    t_phase = time.perf_counter()
    n_total = 2 * FRONTEND_WAVES + FRONTEND_PROFILED
    draws = keys[datasets.zipf_indices(keys.size, n_total * WAVE, alpha=ZIPF, seed=SEED + 9)]
    draw_s = time.perf_counter() - t_phase
    live = _LiveRows(oracle)
    script_s = 0.0  # the oracle's answers, computed before each timed run
    upd = draws[2 * WAVE : 2 * WAVE + WAVE // 4]  # the first UPDATE wave's keys
    t = time.perf_counter()
    plan = st._write_plan(upd)  # the host proof a write wave takes before its issue
    write_plan_ms = (time.perf_counter() - t) * 1e3
    runs = {}
    for i, qd in enumerate((1, 2)):
        t0 = time.perf_counter()
        script = _front_script(live, draws, i * FRONTEND_WAVES, FRONTEND_WAVES)
        script_s += time.perf_counter() - t0
        pipe = PipelinedStore(st, queue_depth=qd)
        c0 = st.stats.flush_cycles
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        results, serial = _front_drive(pipe, script)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.launches)
        _front_check(script, results, f"frontend depth {qd}")
        for k in ("get", "cache_probe_p2", "cache_probe_p1", "range_walk"):
            assert launches[k] > 0, f"kernel {k} was not launched through the pipeline at depth {qd}"
        kinds = [r.kind for r in pipe.ledger.records]
        n_req = sum(q.size for _, q, _ in script)
        s = pipe.pipeline_summary()
        runs[qd] = {
            "waves": len(script), "requests": n_req, "wall_s": wall, "requests_per_s": n_req / wall,
            "served_per_s": len(script) * WAVE / wall,  # serve.py's count: wave_size a wave
            "waves_by_kind": {k: kinds.count(k) for k in sorted(set(kinds))},
            "serial_write_waves": serial, "fast_write_waves": kinds.count("put") - serial,
            "flush_cycles": st.stats.flush_cycles - c0, "pipeline": s,
            "host_roofline_mops": perfmodel.pipelined_wave_mops(
                WAVE, s["issue_us_per_wave"], s["drain_us_per_wave"], qd),
            "launches": launches,
        }
    # the same traffic at depth 2 under the pipeline's own trace
    script = _front_script(live, draws, 2 * FRONTEND_WAVES, FRONTEND_PROFILED)
    pipe = PipelinedStore(st, queue_depth=2)
    build.reset_launches()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir:
        with pipe.pipeline.trace(log_dir):
            t0 = time.perf_counter()
            results, serial = _front_drive(pipe, script)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
        trace_stop_s = time.perf_counter() - t0  # profiler stop and Chrome trace export
        trace_mb = sum(f.stat().st_size for f in Path(log_dir).iterdir()) / 1e6
    _front_check(script, results, "frontend profiled")
    t0 = time.perf_counter()
    ev = pipe.pipeline.last_trace.key_averages()
    key_averages_s = time.perf_counter() - t0
    # the pipeline's spans also appear on the device's timeline as user
    # annotations: they are not device work
    span = f"{pipe.pipeline.name}/"
    dev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith(span)]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    spans = {}
    for e in ev:
        if e.key.startswith(span) and e.device_type == torch.autograd.DeviceType.CPU:
            _, kind, ph = e.key.split("/")
            key = f"{kind}_{ph.split('#')[0]}_ms"
            spans[key] = spans.get(key, 0.0) + e.cpu_time_total / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    r1, r2 = runs[1]["requests_per_s"], runs[2]["requests_per_s"]
    emit({
        "phase": "frontend", "keys": int(keys.size), "wave": WAVE, "waves_per_depth": FRONTEND_WAVES,
        "mix": "serve_kv: 2 GET of 65536, UPDATE of the first 16384 (repeats), RANGE of 64 (limit 10, 4 leaves)",
        "depth1": runs[1], "depth2": runs[2], "requests_per_s_ratio_2_to_1": r2 / r1,
        "write_plan_ms_16384_keys": write_plan_ms, "write_plan_fast": plan is not None,
        "draw_s": draw_s, "oracle_script_s": script_s,
        "profiled": {
            "waves": len(script), "wall_ms": wall_ms, "device_ms": dev_ms, "device_busy": dev_ms / wall_ms,
            "device_launches": sum(e.count for e in dev), "serial_write_waves": serial,
            "span_cpu_ms": spans, "trace_mb": trace_mb, "trace_stop_s": trace_stop_s,
            "key_averages_s": key_averages_s, "launches": dict(build.launches),
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count] for e in top],
        },
        "oracle": "all GET, UPDATE and RANGE answers equal", "seconds": time.perf_counter() - t_phase,
    })


def frontend_parity(torch, dev) -> None:
    """Twin 1M-key stores on the card: ``serve_kv``'s script run serially on
    one and through ``PipelinedStore(queue_depth=2)`` on the other, with
    every ticket redeemed only at the end.  Everything must be identical."""
    from repro_torch.core import DPAStore, datasets
    from repro_torch.serving.pipeline import PipelinedStore

    t_phase = time.perf_counter()
    W = FRONT_PARITY_WAVE
    pkeys = datasets.sparse(FRONT_PARITY_KEYS, seed=SEED + 10)
    pvals = pkeys ^ np.uint64(0xC0FFEE)
    serial, piped = (DPAStore(pkeys, pvals, device=dev) for _ in range(2))
    pipe = PipelinedStore(piped, queue_depth=2)
    idx = datasets.zipf_indices(pkeys.size, FRONT_PARITY_WAVES * W, alpha=ZIPF, seed=SEED + 11)
    want, tickets = [], []
    for w in range(FRONT_PARITY_WAVES):
        q = pkeys[idx[w * W : (w + 1) * W]]
        if w % 4 < 2:
            want.append(serial.get(q))
            tickets.append(pipe.submit_get(q))
        elif w % 4 == 2:
            upd = q[: W // 4]
            want.append(serial.put(upd, upd))
            tickets.append(pipe.submit_put(upd, upd))
        else:
            want.append(serial.range(q[:FRONTEND_RANGE], limit=10))
            tickets.append(pipe.submit_range(q[:FRONTEND_RANGE], 10))
    got = [pipe.result(t) for t in tickets]
    for i, (a, b) in enumerate(zip(want, got, strict=True)):
        _same([a, b], f"frontend-parity wave {i}")
    _same([serial.items(), pipe.items()], "frontend-parity items")
    for f in ("flush_cycles", "puts", "gets", "ranges", "stitch_applies"):
        assert getattr(serial.stats, f) == getattr(piped.stats, f), f"frontend-parity {f}"
    s = pipe.pipeline_summary()
    assert s["overlap_frac"] > 0 and serial.stats.flush_cycles > 0
    emit({"phase": "frontend-parity", "keys": FRONT_PARITY_KEYS, "waves": FRONT_PARITY_WAVES, "wave": W,
          "queue_depth": 2, "identical": True, "flush_cycles": serial.stats.flush_cycles,
          "pipeline": s, "seconds": time.perf_counter() - t_phase})
    del serial, piped, pipe


def tenants_phase(torch, dev, keys) -> None:
    """The 4-tenant deployment of ``launch/serve.py`` on phase 3's keys
    re-encoded into tenant slabs (about 50M keys): ``TENANT_ITERS``
    iterations of ``serve_kv_tenants``' request mix through ``KVWaveDriver``
    with the documented admission and deadline settings.  Every admitted
    reply is held against the oracle, ops applied in ticket order and RANGE
    rows clipped at the tenant's ceiling and decoded to local keys."""
    from repro_torch.core import DPAStore, TreeConfig
    from repro_torch.core import keys as keymod
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.serving.admission import ADMIT_OK, ADMIT_RETRY, AdmissionController, TenantPolicy
    from repro_torch.serving.engine import KVWaveDriver

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    local, ek, ev = serve.tenant_slabs(keys, TENANTS)
    slabs_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    st = DPAStore(ek, ev, TreeConfig(), device=dev)  # default caches and scan cache, as the launcher
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    oracle = Oracle(ek, ev)  # no key dies here: every encoded key stays live
    ceil = {t: keymod.tenant_ceil(t) for t in range(TENANTS)}
    adm = AdmissionController({t: TenantPolicy(rate=TENANT_RATE if t == 0 else 0.0,
                                               weight=TENANT_WEIGHT0 if t == 0 else 1.0) for t in range(TENANTS)})
    drv = KVWaveDriver(st, queue_depth=2, wave_size=TENANT_WAVE, max_delay=TENANT_DELAY, admission=adm,
                       tenant_bits=keymod.TENANT_BITS, max_leaves=4)
    rng = np.random.default_rng(0)
    tw = serve.tenant_weights(TENANTS)
    sent = {}  # ticket -> (op, tenant, local keys, vals)
    retries = {t: 0 for t in range(TENANTS)}
    checked = {"get": 0, "put": 0, "range": 0}
    wall = check_s = 0.0

    def check(replies):
        nonlocal check_s
        t_check = time.perf_counter()
        for rep in replies:  # ticket order: the order the ops took effect
            op, t, q, v = sent.pop(rep.ticket)
            if rep.status == ADMIT_RETRY:
                retries[t] += 1
                continue
            assert rep.status == ADMIT_OK and rep.tenant == t and rep.op == op
            enc = keymod.encode_tenant(t, q)
            if op == "get":
                got, found = rep.result
                assert found.all() and (got == oracle.vals[oracle.pos(enc)]).all(), f"tenant GET {rep.ticket}"
            elif op == "put":
                assert (rep.result == 0).all(), f"tenant PUT {rep.ticket}"
                oracle.put(enc, v)
            else:
                cols = np.searchsorted(ek, enc)[:, None] + np.arange(10)[None, :]
                c = np.minimum(cols, ek.size - 1)
                ok = (cols < ek.size) & (ek[c] < ceil[t])
                res = rep.result
                assert (res.counts == ok.sum(axis=1)).all(), f"tenant RANGE {rep.ticket} counts"
                assert (res.keys == np.where(ok, keymod.decode_tenant(ek[c])[1], 0)).all(), f"RANGE {rep.ticket} keys"
                assert (res.vals == np.where(ok, oracle.vals[c], 0)).all(), f"tenant RANGE {rep.ticket} vals"
            checked[op] += 1
        check_s += time.perf_counter() - t_check

    build.reset_launches()
    for w in range(TENANT_ITERS):
        t0 = time.perf_counter()
        for _ in range(max(TENANTS, 2)):
            op, t, q, v = serve.tenant_request(rng, local, tw, TENANT_WAVE, w)
            tk = drv.request(op, q, v, limit=10, tenant=t)
            sent[tk] = (op, t, q, v)
        drv.tick()
        replies = drv.drain() if (w + 1) % 4 == 0 else []
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        check(replies)
    t0 = time.perf_counter()
    replies = drv.drain()
    torch.cuda.synchronize()
    wall += time.perf_counter() - t0
    check(replies)
    launches = dict(build.launches)
    assert not sent, "every request must be answered"
    for k in ("get", "cache_probe_p2", "cache_probe_p1", "range_walk"):
        assert launches[k] > 0, f"kernel {k} was not launched through the tenant scheduler"
    s = drv.scheduler_summary()
    assert s["leaked_rows"] == 0, "cross-tenant RANGE rows"
    n_keys_served = sum(s["rows_served"].values())
    emit({
        "phase": "tenants", "keys": int(ek.size), "tenants": TENANTS, "tenant_keys": [int(x.size) for x in local],
        "wave_size": TENANT_WAVE, "rate0": TENANT_RATE, "weight0": TENANT_WEIGHT0, "max_delay": TENANT_DELAY,
        "iterations": TENANT_ITERS, "slabs_s": slabs_s, "store_build_s": build_s, "wall_s": wall,
        "check_s": check_s,
        "keys_served_per_s": n_keys_served / wall, "waves": s["waves"], "seals": s["seals"],
        "retries": retries, "rows_served": s["rows_served"], "leaked_rows": s["leaked_rows"],
        "replies_checked": checked, "admission": s["admission"], "pipeline": drv.pipeline_summary(),
        "launches": launches, "oracle": "every admitted reply equal", "seconds": time.perf_counter() - t_phase,
    })
    del drv, st, oracle, ek, ev, local
    torch.cuda.empty_cache()


# ------------------------------------------------------ sharded tiers


class _StormOracle:
    """The range tier's answers with ``serve_kv``'s fresh-insert storms
    applied: the loaded keys, then the storm keys, which all lie above them
    in ascending order (value = key, as ``serve.py`` writes), so the live
    key space stays one sorted run."""

    def __init__(self, keys, vals):
        self.keys, self.vals = keys, vals
        self.storms = []
        self.storm_keys = np.zeros(0, dtype=np.uint64)

    def put_storm(self, ks):
        assert ks[0] > (self.storm_keys[-1] if self.storm_keys.size else self.keys[-1])
        self.storms.append(ks)
        self.storm_keys = np.concatenate(self.storms)

    def expect_get(self, q):
        p = np.minimum(np.searchsorted(self.keys, q), self.keys.size - 1)
        f = self.keys[p] == q
        return np.where(f, self.vals[p], 0), f

    def expect_range(self, starts, limit):
        n, m = self.keys.size, self.storm_keys.size
        j = np.searchsorted(self.keys, starts)
        j = np.where(j < n, j, n + np.searchsorted(self.storm_keys, starts))  # a start past the loaded keys
        cols = j[:, None] + np.arange(limit)[None, :]
        in_keys = cols < n
        in_storm = ~in_keys & (cols < n + m)
        ck = np.minimum(cols, n - 1)
        cs = np.clip(cols - n, 0, max(m - 1, 0))
        sk = self.storm_keys[cs] if m else np.zeros_like(cols, dtype=np.uint64)
        k = np.where(in_keys, self.keys[ck], np.where(in_storm, sk, 0))
        v = np.where(in_keys, self.vals[ck], np.where(in_storm, sk, 0))
        return k, v, (in_keys | in_storm).sum(axis=1)

    def items(self):
        return np.concatenate([self.keys, self.storm_keys]), np.concatenate([self.vals, self.storm_keys])


def _check_range(res, want, what):
    for f, x in zip(("keys", "vals", "counts"), want):
        assert (getattr(res, f) == x).all(), f"{what}: RANGE {f}"


def _timed_wave(torch, fn, reps: int = 3):
    """Host wall ms of one synchronised call (median of ``reps``), and its
    outputs: the emulated waves loop over shards on the host."""
    out, times = None, []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return out, float(np.median(times))


def sharded_phase(torch, dev, keys, vals, smi: str) -> dict:
    """The replicated range tier on phase 3's 50M keys: ``launch/serve.py
    --partition range --shards 4 --replication 2 --kill-primary-at 8`` with
    ``--rebalance --rebalance-every 4`` at 65536-request waves through
    ``PipelinedStore(queue_depth=2)``, every answer against the oracle; then
    the device waves over ``stacked()``."""
    from repro_torch.core import CacheConfig, TreeConfig, datasets
    from repro_torch.core.keys import KEY_MAX, limbs_to_tensor, split_u64
    from repro_torch.distributed.kvshard import ShardedDPAStore, serve_wave_emulated, stacked_bytes
    from repro_torch.distributed.rangeshard import make_route_fn, range_wave_emulated
    from repro_torch.distributed.rebalance import RebalanceConfig
    from repro_torch.kernels import build
    from repro_torch.serving.pipeline import PipelinedStore

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    W = WAVE
    t0 = time.perf_counter()
    # the hot cache a single store has by default (the facade's default is
    # none): each shard's GET then runs B2 (P=2) before B1, as phase 3's
    store = ShardedDPAStore(keys, vals, SHARDS, TreeConfig(), cache_cfg=CacheConfig(), partition="range",
                            replication=REPLICAS, device=dev,
                            rebalance_cfg=RebalanceConfig(spread_trigger=SHARDED_TRIGGER, sample_size=SHARDED_SAMPLE))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    oracle = _StormOracle(keys, vals)
    draws = keys[datasets.zipf_indices(keys.size, SHARDED_WAVES * W, alpha=ZIPF, seed=SEED + 12)]
    pipe = PipelinedStore(store, queue_depth=2)
    pending, events, rebalances = [], [], []
    n_req = 0
    recovery_s = None
    fresh_base = keys.max()

    def collect(force=False):
        while len(pending) > (0 if force else 1):
            kind, t, want, i = pending.pop(0)
            res = pipe.result(t)
            if kind == "get":
                assert (res[1] == want[1]).all() and (res[0] == want[0]).all(), f"sharded GET wave {i}"
            elif kind == "put":
                assert (res == 0).all(), f"sharded storm wave {i}: not every write acked"
            else:
                _check_range(res, want, f"sharded wave {i}")

    torch.cuda.synchronize()
    build.reset_launches()
    t_loop = time.perf_counter()
    for w in range(SHARDED_WAVES):
        q = draws[w * W : (w + 1) * W]
        if w % 4 < 2:
            pending.append(("get", pipe.submit_get(q), oracle.expect_get(q), w))
            n_req += q.size
        elif w % 4 == 2:  # serve.py's sequential fresh-insert storm (--rebalance)
            newk = fresh_base + np.uint64(1) + np.arange(W // 4, dtype=np.uint64) * np.uint64(3)
            fresh_base = newk.max()
            oracle.put_storm(newk)
            pending.append(("put", pipe.submit_put(newk, newk), None, w))
            n_req += newk.size
        else:
            starts = q[:FRONTEND_RANGE]
            pending.append(("range", pipe.submit_range(starts, 10, max_leaves=4), oracle.expect_range(starts, 10), w))
            n_req += starts.size
        collect()
        if w + 1 == SHARDED_KILL_AT:
            promoted = pipe.kill_replica(0)  # shard 0's primary; a barrier
            events.append({"wave": w, "killed": "shard 0 primary", "promoted": promoted,
                           "epoch": store.boundary_epoch})
        elif w == SHARDED_KILL_AT:
            pipe.retire_failover()
            t0 = time.perf_counter()
            plan = pipe.recover_replicas()
            torch.cuda.synchronize()
            recovery_s = time.perf_counter() - t0
            events.append({"wave": w, "rebuilt": plan.n_rebuilds, "recovery_s": recovery_s})
        if (w + 1) % SHARDED_REBALANCE_EVERY == 0:
            t0 = time.perf_counter()
            rep = pipe.maybe_rebalance()
            if rep is not None:
                rebalances.append({"wave": w, "seconds": time.perf_counter() - t0, **rep})
    collect(force=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_loop
    launches = dict(build.launches)
    for k in ("get", "cache_probe_p2", "cache_probe_p1", "range_walk"):
        assert launches[k] > 0, f"kernel {k} was not launched on the sharded tier"
    assert store.failovers == 1 and store.recoveries == 1, "the failover and the recovery must happen"
    assert rebalances and store.migrated_keys > 0, "the rebalance must happen"
    storm = oracle.storm_keys
    assert store.client_writes == store.acked_writes == storm.size
    # every acknowledged write reads back from every in-sync replica
    t0 = time.perf_counter()
    dest = store.route_np(storm)
    readback = 0
    for s in range(store.n_shards):
        m = dest == s
        for r in store._in_sync(s):
            v, f = store.groups[s][r].get(storm[m])
            assert f.all() and (v == storm[m]).all(), f"acked writes on shard {s} replica {r}"
            readback += int(m.sum())
    # the replicas of each group hold the same pairs, and the groups
    # together hold exactly the oracle's (items() without its Python dict)
    parts = []
    for s, g in enumerate(store.groups):
        snaps = [st.snapshot_slice(0, KEY_MAX) for st in g]
        for k, v in snaps[1:]:
            assert np.array_equal(k, snaps[0][0]) and np.array_equal(v, snaps[0][1]), f"replicas of group {s}"
        parts.append(snaps[0])
    ok, ov = oracle.items()
    assert np.array_equal(np.concatenate([p[0] for p in parts]), ok), "sharded keys"
    assert np.array_equal(np.concatenate([p[1] for p in parts]), ov), "sharded values"
    check_s = time.perf_counter() - t0
    # the device waves over the stacked serving replicas
    t0 = time.perf_counter()
    tree, ib, depth = store.stacked()
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    stack_b = stacked_bytes(tree, ib)
    rng = np.random.default_rng(SEED + 13)
    qs = np.concatenate([rng.choice(keys, SHARDS * SHARDED_EMU_W - 4096), rng.choice(storm, 2048),
                         rng.integers(0, 2**64 - 1, 2048, dtype=np.uint64)])
    rng.shuffle(qs)
    qs = qs.reshape(SHARDS, SHARDED_EMU_W)
    lq = limbs_to_tensor(split_u64(qs), dev)
    khi, klo = lq[..., 0].contiguous(), lq[..., 1].contiguous()
    route = make_route_fn(store.boundaries)
    allk, allv = oracle.items()
    p = np.minimum(np.searchsorted(allk, qs), allk.size - 1)
    exp_f = allk[p] == qs
    exp_v = np.where(exp_f, allv[p], 0)
    emu, waves = {}, []
    for name, cap in (("ample", SHARDED_EMU_W), ("overflow", SHARDED_EMU_CAP_SMALL)):
        build.reset_launches()
        out, ms = _timed_wave(torch, lambda: serve_wave_emulated(
            tree, ib, khi, klo, cap=cap, depth=depth, eps_inner=store.cfg.eps_inner, eps_leaf=store.cfg.eps_leaf,
            route_fn=route))
        assert build.launches["get"] == 3 * SHARDS, "serve_wave_emulated: one B1 launch per shard"
        vh, vl, fd, okm = (x.cpu().numpy() for x in out)
        v = (vh.view(np.uint32).astype(np.uint64) << np.uint64(32)) | vl.view(np.uint32)
        assert okm.all() == (name == "ample"), f"serve wave {name}: ok"
        assert (fd[okm] == exp_f[okm]).all() and (v[okm] == exp_v[okm]).all(), f"serve wave {name}"
        assert not fd[~okm].any(), f"serve wave {name}: a RETRY row carries an answer"
        waves.append((f"serve_{name}", "serve", {"cap": cap, "eps_leaf": store.cfg.eps_leaf}, khi, klo, out))
        emu[f"serve_{name}"] = {"cap": cap, "ms": ms, "retry_rows": int((~okm).sum()),
                                "requests": int(qs.size), "found": int(fd.sum())}
    starts = qs[:, :16]
    ls = limbs_to_tensor(split_u64(starts), dev)
    build.reset_launches()
    out, ms = _timed_wave(torch, lambda: range_wave_emulated(
        tree, ib, ls[..., 0].contiguous(), ls[..., 1].contiguous(), store.boundaries, cap=32, depth=depth,
        eps_inner=store.cfg.eps_inner, limit=10, fanout=2))
    assert build.launches["range_walk"] >= 3 * SHARDS, "range_wave_emulated: B3 on every shard"
    kh, kl, vh, vl, valid, okm, trunc, rounds = (x.cpu().numpy() for x in out)
    assert okm.all() and not trunc.any()
    ek, ev, ec = oracle.expect_range(starts.reshape(-1), 10)
    j64 = lambda h, l: (h.view(np.uint32).astype(np.uint64) << np.uint64(32)) | l.view(np.uint32)  # noqa: E731
    assert (valid.sum(axis=-1).reshape(-1) == ec).all(), "range wave counts"
    assert (np.where(valid, j64(kh, kl), 0).reshape(-1, 10) == ek).all(), "range wave keys"
    assert (np.where(valid, j64(vh, vl), 0).reshape(-1, 10) == ev).all(), "range wave vals"
    emu["range"] = {"starts": int(starts.size), "limit": 10, "fanout": 2, "ms": ms, "rounds": rounds.tolist()}
    waves.append(("range", "range", {"cap": 32, "limit": 10, "fanout": 2}, ls[..., 0].contiguous(),
                  ls[..., 1].contiguous(), out))
    spread = store.occupancy_spread(flush=True)
    by_kind = {}
    for r in pipe.ledger.records:  # host seconds of issue + drain, per wave kind
        k = by_kind.setdefault(r.kind, {"waves": 0, "s": 0.0})
        k["waves"] += 1
        k["s"] += (r.issue_ns + r.drain_ns) / 1e9
    emit({
        "phase": "sharded", "nvidia_smi": smi, "keys": int(keys.size), "shards": SHARDS, "replication": REPLICAS,
        "sub_stores": SHARDS * REPLICAS, "waves": SHARDED_WAVES, "wave": W,
        "mix": "serve_kv --rebalance: 2 GET of 65536 zipf, a storm of 16384 sequential fresh keys, RANGE of 64",
        "rebalance_cfg": {"spread_trigger": SHARDED_TRIGGER, "sample_size": SHARDED_SAMPLE},
        "build_s": build_s, "wall_s": wall, "requests": n_req, "requests_per_s": n_req / wall,
        "served_per_s": SHARDED_WAVES * W / wall,
        "shard_drain_s": (store.shard_drain_ns / 1e9).tolist(), "events": events, "recovery_s": recovery_s,
        "rebalances": rebalances, "migrated_keys": store.migrated_keys,
        "range_fanout": store.range_subqueries / max(store.range_requests, 1),
        "range_rounds_in_mesh": store.range_rounds_in_mesh, "range_reissues": store.range_reissues,
        "write_amplification": store.write_amplification, "client_writes": store.client_writes,
        "acked_writes": store.acked_writes, "replica_writes": store.replica_writes,
        "acked_read_back": readback, "occupancy": spread, "boundary_epoch": store.boundary_epoch,
        "pipeline": pipe.pipeline_summary(), "wave_s_by_kind": by_kind,
        "flush_cycles": store.stats_totals()["flush_cycles"], "launches": launches, "check_s": check_s,
        "stacked_s": stack_s, "stacked_bytes": stack_b, "emulated": emu,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "oracle": "every answer, every acked write on every in-sync replica, replicas equal, content equal",
        "seconds": time.perf_counter() - t_phase,
    })
    boundaries, eps_inner = store.boundaries, store.cfg.eps_inner
    del pipe, store, oracle, draws
    torch.cuda.empty_cache()
    # the dist step's inputs: the stack, and the emulated waves' requests, caps and outputs
    return {"tree": tree, "ib": ib, "depth": depth, "eps_inner": eps_inner, "boundaries": boundaries,
            "waves": waves}


def _sharded_stream(torch, pair, part, pkeys, prng, snap_dir):
    """One seeded op stream on twin facades (the card's, the CPU's): every
    answer compared.  Returns the number of compared calls."""
    from repro_torch.core.keys import limbs_to_tensor, split_u64
    from repro_torch.distributed import kvshard, rangeshard, snapshot

    n = 0

    def both(name, *args, **kw):
        nonlocal n
        outs = [getattr(s, name)(*args, **kw) for s in pair]
        _same(outs, f"{part}: {name}")
        n += 1
        return outs

    def waves():
        nonlocal n
        stacks = [s.stacked() for s in pair]
        S = pair[0].n_shards
        qs = np.concatenate([prng.choice(pkeys, S * 900), prng.integers(0, 2**64 - 1, S * 124, dtype=np.uint64)])
        qs = qs.reshape(S, 1024)
        route = rangeshard.make_route_fn(pair[0].boundaries) if part == "range" else None
        for cap in (1024, 96):
            outs = []
            for (tree, ib, depth), s in zip(stacks, pair):
                l = limbs_to_tensor(split_u64(qs), s.device)
                outs.append(tuple(x.cpu().numpy() for x in kvshard.serve_wave_emulated(
                    tree, ib, l[..., 0].contiguous(), l[..., 1].contiguous(), cap=cap, depth=depth,
                    eps_inner=4, eps_leaf=8, route_fn=route)))
            _same(outs, f"{part}: serve wave cap {cap}")
            n += 1
            if part == "range":
                outs = []
                for (tree, ib, depth), s in zip(stacks, pair):
                    l = limbs_to_tensor(split_u64(qs[:, :64]), s.device)
                    outs.append(tuple(x.cpu().numpy() for x in rangeshard.range_wave_emulated(
                        tree, ib, l[..., 0].contiguous(), l[..., 1].contiguous(), s.boundaries, cap=cap // 8,
                        depth=depth, eps_inner=4, limit=16, max_leaves=2, fanout=2, max_rounds=cap // 512)))
                _same(outs, f"{part}: range wave cap {cap}")
                n += 1

    def reads(q, epoch=None):
        both("get", q, epoch=epoch)
        both("range", q[:512], 10, epoch=epoch)

    for step in range(4):
        q = np.concatenate([prng.choice(pkeys, 3000), prng.integers(0, 2**64 - 1, 500, dtype=np.uint64)])
        reads(q)
        newk = prng.integers(1, 2**63, 1200, dtype=np.uint64)
        both("put", newk, newk ^ np.uint64(step + 1))
        both("delete", prng.choice(pkeys, 400))
        starts = q[:512]
        both("range", starts, 40, max_leaves=1, k_max=starts + np.uint64(2**52))
        if part == "range":
            both("range", starts, 20, fanout=2)
        _same([s.get_finalize(s.get_issue(q[:2048])) for s in pair], f"{part}: get halves")
        _same([s.range_finalize(s.range_issue(starts, 10)) for s in pair], f"{part}: range halves")
        ks = prng.choice(pkeys, 256)
        ws = [s.write_issue("put", ks, ks ^ np.uint64(7)) for s in pair]
        assert (ws[0] is None) == (ws[1] is None)
        if ws[0] is not None:
            _same([s.write_finalize(w) for s, w in zip(pair, ws)], f"{part}: write halves")
        else:
            both("put", ks, ks ^ np.uint64(7))
        # a bounded resume on the serving store of shard 0, as the facade's host fallback runs it
        rs = [s.shards[0].range_with_state(starts, limit=64, max_leaves=1, max_rounds=1) for s in pair]
        _same(rs, f"{part}: bounded")
        m = rs[0].truncated
        if m.any():
            _same([s.shards[0].range_with_state(starts[m], limit=64, max_leaves=1, start_leaves=r.cursor_leaf[m])
                   for s, r in zip(pair, rs)], f"{part}: resumed")
        both("put", ks[:64], ks[:64], ttl=2)  # TTL puts
        if step == 1:
            both("flush")
            waves()
        if part == "range" and step == 1:
            both("kill_replica", 0)
            reads(q, epoch=pair[0].boundary_epoch - 1)
            both("retire_failover")
            both("recover_replicas")
            storm = pkeys.max() + np.uint64(1) + np.arange(3000, dtype=np.uint64) * np.uint64(3)
            both("put", storm, storm)
            nb = pair[0].planner.propose(pair[0].boundaries)
            both("begin_rebalance", nb)
            reads(q, epoch=pair[0].boundary_epoch - 1)
            reads(q)
            both("commit_rebalance")
        if part == "range" and step == 2:
            both("reshard", 4)
            reads(q)
            both("reshard", 3)
        for s in pair:
            s.ttl.tick(1)
    both("ttl_sweep")
    both("compact_chain")
    both("stub_count")
    e = both("snapshot_epoch")[0]
    both("put", pkeys[:100], pkeys[:100] ^ np.uint64(1))
    q = prng.choice(pkeys, 2048)
    both("get", q, as_of=e)
    both("range", q[:256], 10, as_of=e)
    waves()
    _same([s.items() for s in pair], f"{part}: items")
    for c in ("range_requests", "range_subqueries", "range_reissues", "range_rounds_in_mesh", "client_writes",
              "replica_writes", "acked_writes", "failovers", "recoveries", "rebalances", "migrated_keys",
              "reshards", "resharded_keys", "n_shards", "boundary_epoch"):
        assert getattr(pair[0], c) == getattr(pair[1], c), f"{part}: {c}"
    assert pair[0].stats_totals() == pair[1].stats_totals(), f"{part}: stats_totals"
    # a snapshot of the card's facade restores at another shard count, on the card and on the CPU
    snapshot.save_snapshot(pair[0], snap_dir)
    n_other = 2 if pair[0].n_shards != 2 else 3
    restored = [snapshot.restore_store(snap_dir, n_shards=n_other, device=s.device) for s in pair]
    want = pair[0].items()
    for r in restored:
        _same([r.items(), want], f"{part}: restored at {n_other} shards")
    return n


def sharded_parity(torch, dev) -> None:
    """Twin 600k-key facades on the card and on the CPU, for the
    replicated range tier (R=2, 2 shards, resharded 2 -> 4 -> 3) and the
    hash tier (4 shards): one seeded op stream each, every answer,
    ``items()`` and counter identical."""
    import tempfile

    from repro_torch.core import CacheConfig, TreeConfig, datasets
    from repro_torch.distributed.kvshard import ShardedDPAStore
    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    pkeys = datasets.sparse(SHARDED_PARITY_KEYS, seed=SEED + 14)
    pvals = pkeys ^ np.uint64(0x51AB)
    calls = {}
    build.reset_launches()
    for part, n_shards, R in (("range", 2, 2), ("hash", 4, 1)):
        pair = [ShardedDPAStore(pkeys, pvals, n_shards, TreeConfig(growth=SHARDED_PARITY_GROWTH), partition=part,
                                cache_cfg=CacheConfig(), replication=R, retain_epochs=SHARDED_PARITY_RETAIN, device=d)
                for d in (dev, "cpu")]
        with tempfile.TemporaryDirectory() as d:
            calls[part] = _sharded_stream(torch, pair, part, pkeys, np.random.default_rng(SEED + 15), Path(d))
        del pair
    launches = dict(build.launches)
    for k in ("get", "cache_probe_p2", "cache_probe_p1", "range_walk"):
        assert launches[k] > 0, f"sharded-parity: kernel {k} did not run on the card"
    emit({"phase": "sharded-parity", "keys": SHARDED_PARITY_KEYS, "tiers": {"range": "2 shards x R=2, resharded 2->4->3",
          "hash": "4 shards"}, "compared_calls": calls, "identical": True, "launches": launches,
          "seconds": time.perf_counter() - t_phase})


def _rank_summary(reports, n_waves):
    """Per wave, each rank's median host ms, its exchange ms and bytes."""
    return [{"host_ms": [float(np.median(r["waves"][i]["host_ms"])) for r in reports],
             "exchange_ms": [r["waves"][i]["exchange_ms"] for r in reports],
             "exchanges": reports[0]["waves"][i]["exchanges"],
             "bytes_per_rank": [r["waves"][i]["bytes"] for r in reports]} for i in range(n_waves)]


def _assert_rank_launches(reports, what, kernels=("get", "range_walk")):
    for r, rep in enumerate(reports):
        for k in kernels:
            assert rep["launches"][k] > 0, f"{what}: kernel {k} did not run in rank {r}"


def dist_phase(torch, dev, ctx: dict, smi: str) -> None:
    """The sharded phase's stacked 50M-key range tier on one gloo rank per
    shard, all on the card (the pools reach the ranks as CUDA IPC handles):
    ``serve_wave_sharded`` and ``range_wave_sharded`` on the exact requests
    and caps of the phase's emulated waves, each rank's rows gathered and
    held bitwise against the emulated outputs (which the phase held against
    the oracle); B1 and B3 must run in every rank."""
    from repro_torch.distributed.kvshard import stacked_bytes
    from repro_torch.launch.local_ranks import WaveCase, spawn_waves

    t_phase = time.perf_counter()
    depth, eps_inner = ctx["depth"], ctx["eps_inner"]
    cases, names = [], []
    for name, kind, params, khi, klo, _ in ctx["waves"]:
        kw = dict(params, depth=depth, eps_inner=eps_inner)
        cases.append(WaveCase(kind, khi.cpu(), klo.cpu(), kw, boundaries=ctx["boundaries"]))
        names.append(name)
    outs, reports = spawn_waves([(ctx["tree"], ctx["ib"])], cases, device=dev, backend="gloo", reps=DIST_REPS)
    for name, got, (*_, want) in zip(names, outs, ctx["waves"]):
        for i, (a, b) in enumerate(zip(got, want, strict=True)):
            assert a.shape == b.shape and torch.equal(a, b.cpu()), f"dist {name}: output {i}"
    _assert_rank_launches(reports, "dist")
    ok = outs[names.index("serve_overflow")][3]
    emit({"phase": "dist", "nvidia_smi": smi, "ranks": len(reports), "backend": reports[0]["backend"],
          "device": reports[0]["device"], "stacked_bytes": stacked_bytes(ctx["tree"], ctx["ib"]),
          "waves": dict(zip(names, _rank_summary(reports, len(cases)))), "reps": DIST_REPS,
          "requests": {n: list(c.khi.shape) for n, c in zip(names, cases)},
          "retry_rows_overflow": int((~ok).sum()), "rounds": outs[names.index("range")][7].tolist(),
          "launches": [r["launches"] for r in reports], "identical": True,
          "seconds": time.perf_counter() - t_phase})


def _to_dev(state, dev):
    return type(state)(*(t.to(dev) for t in state))


def dist_parity(torch, dev) -> None:
    """At ``sharded_parity``'s 600k keys: the range tier (4 shards) before
    and during a live rebalance, 4 gloo ranks on the card against the port's
    emulated waves on the CPU, bitwise — hash and range routing, both
    epochs, a mixed-epoch tagged GET and RANGE wave, RANGE at ``limit=5,
    max_leaves=8``, the looped ``limit=40, max_leaves=1`` (per-shard rounds
    equal, some > 1) and a small cap with RETRY rows.  Then one NCCL
    process group of world size 1 on the hash tier: ``serve_wave_sharded``
    equal to the emulated wave at ``n_shards=1`` and to the store's GET."""
    import tempfile

    import torch.distributed as tdist

    from repro_torch.core import TreeConfig, datasets
    from repro_torch.core.keys import limbs_to_tensor, split_u64
    from repro_torch.distributed.kvshard import ShardedDPAStore, serve_wave_emulated, serve_wave_sharded, shard_state
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch.local_ranks import WaveCase, spawn_waves

    t_phase = time.perf_counter()
    pkeys = datasets.sparse(SHARDED_PARITY_KEYS, seed=SEED + 16)
    pvals = pkeys ^ np.uint64(0xD157)
    st = ShardedDPAStore(pkeys, pvals, SHARDS, TreeConfig(growth=SHARDED_PARITY_GROWTH), partition="range",
                         cache_cfg=None, device="cpu")
    old = st.stacked()
    b_old = st.boundaries.copy()
    storm = pkeys.max() + np.uint64(1) + np.arange(DIST_PARITY_STORM, dtype=np.uint64) * np.uint64(3)
    st.put(storm, storm ^ np.uint64(0xD157))
    st.flush()
    assert st.begin_rebalance(st.planner.propose(st.boundaries)), "the storm must open a rebalance"
    new = st.stacked()
    b_new = st.boundaries.copy()
    assert old[2] == new[2], "one tree depth across both stacks"
    depth = new[2]
    rng = np.random.default_rng(SEED + 17)
    W = DIST_PARITY_W
    allk = np.concatenate([pkeys, storm])
    qs = np.concatenate([rng.choice(allk, SHARDS * W * 3 // 4),
                         rng.integers(0, 2**64 - 1, SHARDS * W // 4, dtype=np.uint64)])
    rng.shuffle(qs)
    lq = limbs_to_tensor(split_u64(qs.reshape(SHARDS, W)), "cpu")
    kh, kl = lq[..., 0].contiguous(), lq[..., 1].contiguous()
    tag = torch.from_numpy(rng.integers(0, 2, (SHARDS, W)).astype(np.int32))
    g = dict(depth=depth, eps_inner=4, eps_leaf=8)
    r = dict(depth=depth, eps_inner=4)
    ample = SHARDS * W
    cases = {
        "get hash": WaveCase("serve", kh, kl, dict(cap=ample, **g), state=1),
        "get old epoch": WaveCase("serve", kh, kl, dict(cap=ample, **g), boundaries=b_old),
        "get new epoch": WaveCase("serve", kh, kl, dict(cap=ample, **g), boundaries=b_new, state=1),
        "get mixed epoch": WaveCase("serve", kh, kl, dict(cap=ample, **g), boundaries=b_new, boundaries_prev=b_old,
                                    epoch_tag=tag, state=1),
        "get retry": WaveCase("serve", kh, kl, dict(cap=W // 8, **g), boundaries=b_new, state=1),
        "range old epoch": WaveCase("range", kh, kl, dict(cap=ample, limit=5, max_leaves=8, **r), boundaries=b_old),
        "range new epoch": WaveCase("range", kh, kl, dict(cap=ample, limit=5, max_leaves=8, **r), boundaries=b_new,
                                    state=1),
        "range mixed epoch": WaveCase("range", kh, kl, dict(cap=ample, limit=5, max_leaves=8, **r), boundaries=b_new,
                                      boundaries_prev=b_old, epoch_tag=tag, state=1),
        "range looped": WaveCase("range", kh, kl, dict(cap=ample, limit=40, max_leaves=1, **r), boundaries=b_new,
                                 state=1),
        "range retry": WaveCase("range", kh, kl, dict(cap=W // 8, limit=5, max_leaves=8, fanout=2, **r),
                                boundaries=b_new, state=1),
    }
    states = [old[:2], new[:2]]
    want = {n: c.emulated(*states[c.state]) for n, c in cases.items()}
    outs, reports = spawn_waves([(_to_dev(t, dev), _to_dev(i, dev)) for t, i in states], list(cases.values()),
                                device=dev, backend="gloo")
    for (n, c), got in zip(cases.items(), outs):
        for i, (a, b) in enumerate(zip(got, want[n], strict=True)):
            assert a.shape == b.shape and torch.equal(a, b), f"dist-parity {n}: output {i}"
    _assert_rank_launches(reports, "dist-parity")
    got = dict(zip(cases, outs))
    assert not got["get retry"][3].all() and got["get retry"][3].any(), "RETRY rows at the small cap"
    assert not got["range retry"][5].all(), "RETRY rows in the small-cap RANGE wave"
    assert int(got["range looped"][7].max()) > 1 and not got["range looped"][6].any(), "the looped RANGE"
    del st, old, new, states

    # NCCL, world size 1, on the hash tier
    build.reset_launches()
    hs = ShardedDPAStore(pkeys, pvals, 1, TreeConfig(), partition="hash", cache_cfg=None, device=dev)
    tree, ib, hdepth = hs.stacked()
    q1 = np.concatenate([rng.choice(pkeys, 6000), rng.integers(0, 2**64 - 1, 2192, dtype=np.uint64)])
    l1 = limbs_to_tensor(split_u64(q1[None]), dev)
    k1h, k1l = l1[..., 0].contiguous(), l1[..., 1].contiguous()
    kw = dict(cap=q1.size, depth=hdepth, eps_inner=4, eps_leaf=8)
    with tempfile.TemporaryDirectory() as d:
        backend = meshes.init_process_group(0, 1, f"file://{d}/rendezvous", device=dev)
        try:
            m = meshes.make_debug_mesh(1, 1, device=dev)
            fn = serve_wave_sharded(m, tree, ib, **kw)
            nccl = fn(*shard_state(tree, ib, 0), k1h, k1l)
            torch.cuda.synchronize()
            x = fn.exchange
            nccl_x = {"exchanges": x.calls, "bytes": x.bytes, "exchange_ms": x.seconds * 1e3}
        finally:
            tdist.destroy_process_group()
    assert build.launches["get"] == 1, "serve_wave_sharded: one B1 launch at world size 1"
    emu = serve_wave_emulated(tree, ib, k1h, k1l, **kw)
    for i, (a, b) in enumerate(zip(nccl, emu, strict=True)):
        assert torch.equal(a, b), f"NCCL world size 1: output {i}"
    v, f = hs.get(q1)
    vh, vl, fd, okm = (t[0].cpu().numpy() for t in nccl)
    assert okm.all() and np.array_equal(fd, f), "NCCL world size 1: found against the store's GET"
    v1 = (vh.view(np.uint32).astype(np.uint64) << np.uint64(32)) | vl.view(np.uint32)
    assert np.array_equal(v1[fd], v[f]), "NCCL world size 1: values against the store's GET"
    emit({"phase": "dist-parity", "keys": SHARDED_PARITY_KEYS, "storm": DIST_PARITY_STORM, "shards": SHARDS,
          "ranks": len(reports), "backend": reports[0]["backend"], "requests_per_rank": W,
          "compared": list(cases), "identical": True,
          "retry_rows": {n: int((~got[n][3 if n.startswith("get") else 5]).sum()) for n in ("get retry", "range retry")},
          "looped_rounds": got["range looped"][7].tolist(), "mixed_tags": [int((tag == 0).sum()), int((tag == 1).sum())],
          "waves": dict(zip(cases, _rank_summary(reports, len(cases)))),
          "launches": [rk["launches"] for rk in reports],
          "nccl": {"backend": backend, "world_size": 1, "requests": int(q1.size), "found": int(fd.sum()), **nccl_x},
          "seconds": time.perf_counter() - t_phase})
    del hs, tree, ib
    torch.cuda.empty_cache()


def kv_dryrun_phase(torch, dev) -> None:
    """``python -m repro_torch.launch.kv_dryrun --mesh both`` on the card, as
    a user runs it: both records written, one rank's wave at the production
    per-shard size (3,125,000 keys, 4096 requests, cap 4096) checked against
    its keys, and the bytes per device and wave equal to 5 exchanges of a
    ``(16, 4096)`` int32 tensor."""
    import os
    import tempfile

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        p = subprocess.run([sys.executable, "-m", "repro_torch.launch.kv_dryrun", "--mesh", "both", "--out", d],
                           cwd=root, env=env, capture_output=True, text=True, timeout=300)
        if p.returncode != 0:
            raise AssertionError(f"kv_dryrun: exit {p.returncode}\n{p.stdout[-3000:]}{p.stderr[-3000:]}")
        recs = [json.loads((Path(d) / f"dpastore-service__wave__{m}.json").read_text())
                for m in ("pod16x16", "pod2x16x16")]
    for rec in recs:
        assert rec["status"] == "ok" and rec["device"] == torch.cuda.get_device_name(0), rec["mesh"]
        assert rec["collective_bytes_per_device"] == KV_DRYRUN_BYTES, rec["collective_bytes_per_device"]
        assert rec["n_shards"] == 16 and rec["keys_per_shard"] == 3_125_000 and rec["cap"] == 4096
        assert rec["launches"]["get"] > 0, "kv_dryrun: B1 did not run"
        emit({"phase": "kv-dryrun", **rec})
    emit({"phase": "kv-dryrun-cli", "exit": p.returncode, "out": p.stdout.splitlines(),
          "seconds": time.perf_counter() - t})


def serve_cli_phase(torch, dev) -> None:
    """``python -m repro_torch.launch.serve`` on the card, as a user runs it:
    the versioned/TTL command, the 4-tenant command and the reference's four
    sharded commands, each at ``CLI_KEYS``.  Each must exit 0 and print its
    tier's report lines; the reshard command's snapshot must restore through
    ``restore_store`` at 3 shards with the snapshot's pairs as ``items()``."""
    import os
    import tempfile

    from repro_torch.distributed import snapshot

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    n = str(CLI_KEYS)
    runs = []
    with tempfile.TemporaryDirectory() as snap_dir:
        for argv, musts in (
            (["--kv", "--n-keys", n, "--waves", "16", "--wave-size", "8192", "--retain-epochs", "64", "--ttl", "4"],
             ["-> bitwise match"]),
            (["--kv", "--n-keys", n, "--tenants", str(TENANTS), "--tenant-rate", f"0:{int(TENANT_RATE)}",
              "--tenant-weights", f"0:{TENANT_WEIGHT0}", "--max-delay", str(TENANT_DELAY)],
             ["cross-tenant leaks=0"]),
            (["--kv", "--n-keys", n, "--partition", "hash", "--shards", "4"],
             ["partition=hash shards=4 range fan-out=4.00"]),
            (["--kv", "--n-keys", n, "--partition", "range", "--shards", "4", "--rebalance", "--rebalance-every", "4"],
             ["partition=range shards=4", "[serve-kv] rebalance: "]),
            (["--kv", "--n-keys", n, "--partition", "range", "--shards", "4", "--replication", "2",
              "--kill-primary-at", "8"],
             ["killed shard 0 primary", "re-replicated 1 replica(s)", "[serve-kv] replication: R=2", "1 failover(s)"]),
            (["--kv", "--n-keys", n, "--partition", "range", "--shards", "2", "--reshard-to", "4", "--snapshot-dir",
              snap_dir],
             ["-> 4 shards", "[serve-kv] elastic: 1 reshard(s)", "[serve-kv] snapshot: "]),
        ):
            t = time.perf_counter()
            p = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *argv], cwd=root, env=env,
                               capture_output=True, text=True, timeout=300)
            sec = time.perf_counter() - t
            if p.returncode != 0 or any(m not in p.stdout for m in musts):
                raise AssertionError(f"serve {' '.join(argv)}: exit {p.returncode}\n{p.stdout[-3000:]}{p.stderr[-3000:]}")
            lines = [ln for ln in p.stdout.splitlines() if "stats:" not in ln and "stats totals:" not in ln]
            runs.append({"argv": [a if a != snap_dir else "<tmp>" for a in argv], "exit": p.returncode,
                         "seconds": sec, "out": lines})
        t = time.perf_counter()
        snap = snapshot.load_snapshot(snap_dir)
        st = snapshot.restore_store(snap, n_shards=3, device=dev)
        assert st.n_shards == 3 and snap.n_shards == 4
        _same([st.items(), (snap.keys, snap.vals)], "restored snapshot")
        restore = {"keys": snap.n_keys, "writer_shards": snap.n_shards, "reader_shards": st.n_shards,
                   "seconds": time.perf_counter() - t}
        del st
    emit({"phase": "serve-cli", "runs": runs, "restore": restore})


# ----------------------------------------------------------- paged phase


def _median_ms(xs) -> float:
    return float(np.median(xs) * 1e3) if len(xs) else float("nan")


def _page_table_population(rng, n_blocks: int, live_ids):
    """Other sequences' pages for the page table: ids drawn around the live
    sequences' ids, each with whole blocks of 4k-12k tokens, until the pool
    is ``PAGED_BG_FILL`` full.  Returns (items, seq_len, free): the table's
    sorted (keys, vals), ``{seq_id: tokens}``, and the free slot list in pop
    order, with the slots taken as appends take them (0, 1, 2, ...)."""
    from repro_torch.serving.paged_cache import BLOCK_BITS, _SENTINEL_SEQ, page_key

    ids = rng.permutation(np.setdiff1d(np.arange(1, 4096), live_ids))
    target = int(PAGED_BG_FILL * n_blocks)
    counts = []
    while sum(counts) < target:
        counts.append(int(min(rng.integers(PAGED_BG_BLOCKS[0], PAGED_BG_BLOCKS[1] + 1), target - sum(counts))))
    ids = ids[: len(counts)].astype(np.uint64)
    counts = np.array(counts)
    keys = np.concatenate([(i << np.uint64(BLOCK_BITS)) | np.arange(c, dtype=np.uint64) for i, c in zip(ids, counts)])
    vals = np.arange(keys.size, dtype=np.uint64)
    keys = np.append(keys, np.uint64(page_key(_SENTINEL_SEQ, 0)))
    vals = np.append(vals, np.uint64(0))
    order = np.argsort(keys)
    seq_len = {int(i): int(c) * PAGED_BLOCK for i, c in zip(ids, counts)}
    free = list(range(n_blocks - 1, int(counts.sum()) - 1, -1))
    return (keys[order], vals[order]), seq_len, free


def paged_phase(torch, dev, kernels) -> None:
    """Phase 5: the paged KV cache path, kernels B1-B3 on its page table,
    then kernel B4 against its plain version.  Adds B4's entry to
    ``kernels``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build, ops, paged_gather
    from repro_torch.models.layers import decode_attention
    from repro_torch.serving.engine import PagedAttentionLayer
    from repro_torch.serving.paged_cache import PagedCache, page_key

    torch.backends.cuda.matmul.allow_tf32 = False  # attention products in full f32
    H, HKV, HD, BS, NB = PAGED_HEADS, PAGED_KV_HEADS, PAGED_HEAD_DIM, PAGED_BLOCK, PAGED_BLOCKS
    rng = np.random.default_rng(SEED + 4)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    layer = PagedAttentionLayer(HKV, HD, block_size=BS, n_blocks=NB, device=dev)
    pool_bytes = 2 * layer.cache.pool_k.numel() * layer.cache.pool_k.element_size()
    assert pool_bytes == 2 * NB * BS * HKV * HD * 2, "two bf16 pools"

    ids = [101 + i for i in range(PAGED_SEQS)]
    prompt = dict(zip(ids, (int(n) for n in rng.integers(PAGED_PROMPT[0], PAGED_PROMPT[1] + 1, PAGED_SEQS))))
    decode = dict(zip(ids, (int(n) for n in rng.integers(PAGED_DECODE[0], PAGED_DECODE[1] + 1, PAGED_SEQS))))
    lengths = {sid: prompt[sid] + decode[sid] for sid in ids}
    reappend = (901, PAGED_REAPPEND)
    t = time.perf_counter()
    items, bg_len, free = _page_table_population(rng, NB, [*ids, reappend[0]])
    layer.cache = cache = PagedCache.from_state(layer.cache.pool_k, layer.cache.pool_v, free, bg_len, items)
    torch.cuda.synchronize()
    table_build_s = time.perf_counter() - t
    table_keys = int(items[0].size)

    n_tok = sum(lengths.values()) + reappend[1] + 2
    kv = torch.randn((2, n_tok, HKV, HD), generator=gen, device=dev)  # f32 K and V per token
    n_att = sum(decode.values())
    qs = torch.randn((n_att + 2, H, HD), generator=gen, device=dev)
    tokens = {sid: [] for sid in [*ids, reappend[0]]}
    alloc = {sid: [] for sid in tokens}  # host record of the slots the appends took
    put_s, get_s = [], []
    nxt = 0

    def append(sid) -> float:
        nonlocal nxt
        pos = cache.seq_len.get(sid, 0)
        if pos % BS == 0 and sid in alloc:
            alloc[sid].append(cache.free[-1])
        t = time.perf_counter()
        layer.append(sid, kv[0, nxt], kv[1, nxt])
        dt = time.perf_counter() - t
        (put_s if pos % BS == 0 else get_s).append(dt)
        if sid in tokens:
            tokens[sid].append(nxt)
        nxt += 1
        return dt

    # warm-up, not timed or counted: two decode steps of a background
    # sequence (a PUT append, then a GET append, each with an attend)
    warm = next(iter(bg_len))
    for i in range(2):
        append(warm)
        layer.attend(warm, qs[n_att + i])
    torch.cuda.synchronize()
    put_s.clear()
    get_s.clear()

    # the path: interleaved steps; a sequence appends its prompt, then each
    # decode step appends one token and attends
    build.reset_launches()
    attend_s, step_s, att = [], [], []
    app_s = 0.0
    t0 = time.perf_counter()
    for step in range(max(lengths.values())):
        for sid in ids:
            if step >= lengths[sid]:
                continue
            dt = append(sid)
            app_s += dt
            if step >= prompt[sid]:
                t = time.perf_counter()
                out = layer.attend(sid, qs[len(att)])
                torch.cuda.synchronize()
                attend_s.append(time.perf_counter() - t)
                step_s.append(dt + attend_s[-1])
                att.append((sid, len(tokens[sid]), out))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    n_appends = sum(lengths.values())
    released = ids[:2]
    freed = []
    for sid in released:
        n_before = len(cache.free)
        assert cache.release(sid) == len(alloc[sid])
        freed += cache.free[n_before:]
    for _ in range(reappend[1]):
        append(reappend[0])
    re_out = layer.attend(reappend[0], qs[n_att + 1])
    torch.cuda.synchronize()
    launches = dict(build.launches)
    for k in ("get", "cache_probe_p2", "cache_probe_p1", "range_walk", "paged_gather"):
        assert launches[k] > 0, f"kernel {k} was not launched on the paged path"
    assert launches["paged_gather"] == n_att + 1, "one gather of K and V per attend"
    peak = torch.cuda.max_memory_allocated() - base

    # -- checks: slot lists, slot reuse, every attend against the dense K/V
    for sid in ids:
        if sid not in released:
            assert cache.lookup_slots(sid).tolist() == alloc[sid], f"slots of sequence {sid}"
    new_slots = cache.lookup_slots(reappend[0]).tolist()
    assert new_slots == alloc[reappend[0]] and set(new_slots) <= set(freed), "freed blocks reused"
    assert all(cache.lookup_slots(sid).size == 0 for sid in released)
    att.append((reappend[0], reappend[1], re_out))
    qidx = [*range(n_att), n_att + 1]
    err = 0.0
    for (sid, n, got), qi in zip(att, qidx):
        idx = torch.tensor(tokens[sid][:n], device=dev)
        dk, dv = (kv[j, idx].to(cache.pool_k.dtype)[None] for j in (0, 1))  # what the pools hold
        want = decode_attention(qs[qi][None, None], dk, dv, n)[0, 0]
        assert got.shape == (H, HD) and bool(torch.isfinite(got).all())
        err = max(err, float((got - want).abs().max()))
    assert err <= ATTEND_TOL, f"paged attention vs dense: {err}"
    assert peak <= 1.25 * pool_bytes, f"peak device memory {peak} for {pool_bytes} of pools"
    st = cache.table.stats
    assert st.flush_cycles == st.stitch_applies and st.flush_cycles > 0

    # -- kernels B1-B3 against their plain versions on the page table's
    # state, at the path's shapes: a 1-request wave, and the walk that
    # lookup_slots starts (limit = blocks + max_leaves x ib_cap)
    longest = max((sid for sid in ids if sid not in released), key=lambda s: lengths[s])
    n_blk = len(alloc[longest])
    ml = max(4, n_blk // 16 + 2)
    q = np.array([page_key(longest, 0)], dtype=np.uint64)
    table_kernels = {}
    for name, (kern, plain, *_rest) in kernel_cases(torch, cache.table, q, n_blk + ml * cache.table.cfg.ib_cap, ml).items():
        max_abs_err(torch, name, kern(), plain())
        table_kernels[name] = {"equal": True, "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain)}
        if name == "get":
            table_kernels[name]["cold_ms"] = time_ms(torch, kern, cold=True)
            table_kernels[name]["plan"] = get_plan(torch, cache.table, 1)
        elif name.startswith("cache_probe"):
            table_kernels[name]["cold_ms"] = time_ms(torch, kern, cold=True)
            table_kernels[name]["plan"] = probe_wave(torch, cache.table, q, int(name[-1]))["plan"]

    # -- where one decode step's time goes, on the longest live sequence
    key = np.array([page_key(longest, 0)], dtype=np.uint64)
    table_get_s = []
    for _ in range(20):
        t = time.perf_counter()
        cache.table.get(key)
        table_get_s.append(time.perf_counter() - t)
    range_s = []
    for _ in range(10):
        t = time.perf_counter()
        slots_np = cache.lookup_slots(longest)
        range_s.append(time.perf_counter() - t)
    sl = torch.from_numpy(slots_np).to(dev)
    gk, gv, n_live = cache.gather(longest)
    gather_ms = time_ms(torch, lambda: ops.paged_gather_kv(cache.pool_k, cache.pool_v, sl))
    attn_ms = time_ms(torch, lambda: decode_attention(qs[0][None, None], gk[None], gv[None], n_live))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        layer.append(longest, kv[0, 0], kv[1, 0])
        layer.attend(longest, qs[0])
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t) * 1e3
    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    emit({
        "phase": "paged", "model": "llama3-405b, one attention layer", "heads": H, "kv_heads": HKV,
        "head_dim": HD, "block_size": BS, "n_blocks": NB, "pool_dtype": str(cache.pool_k.dtype),
        "pool_bytes": pool_bytes, "peak_device_bytes": peak,
        "table_keys_loaded": table_keys, "background_seqs": len(bg_len), "table_build_s": table_build_s,
        "pool_blocks_used": NB - len(cache.free), "table_keys_after": int(cache.table.items()[0].size),
        "prompts": list(prompt.values()), "decodes": list(decode.values()),
        "appends": n_appends, "append_s": app_s, "appends_per_s": n_appends / app_s,
        "loop_s": loop_s, "decode_tokens_per_s": n_att / loop_s,
        "attends": n_att, "attends_per_s": n_att / sum(attend_s), "attend_ms_median": _median_ms(attend_s),
        "attend_ms_p99": float(np.percentile(attend_s, 99) * 1e3), "decode_step_ms_median": _median_ms(step_s),
        "decode_step_ms_p99": float(np.percentile(step_s, 99) * 1e3),
        "released": released, "freed_blocks": len(freed), "reappended_blocks": len(new_slots),
        "launches": launches, "attend_max_abs_err": err, "attend_tol": ATTEND_TOL, "attends_checked": len(att),
        "table": {f: getattr(st, f) for f in ("gets", "puts", "deletes", "ranges", "cache_hits",
                                             "flush_cycles", "stitch_applies", "scan_hits")},
        "table_depth": cache.table.depth, "table_kernels": table_kernels,
        "decode_step": {
            "append_get_ms_median": _median_ms(get_s), "append_put_ms_median": _median_ms(put_s),
            "append_put_ms_max": max(put_s) * 1e3, "table_get_ms_median": _median_ms(table_get_s),
            "range_ms_median": _median_ms(range_s), "range_blocks": int(sl.numel()),
            "gather_kv_device_ms": gather_ms, "attention_device_ms": attn_ms,
            "profiled_wall_ms": prof_wall_ms, "profiled_device_ms": dev_ms, "device_busy": dev_ms / prof_wall_ms,
            "device_launches": sum(e.count for e in ev),
        },
        "seconds": time.perf_counter() - t_phase,
    })

    # -- kernel B4 against its plain versions and index_select: one pool and
    # the K and V pair, at the path's slot list (fewer slots than SMs), at a
    # longer random list and at 16384 random slots of random pools
    gen_pools = [torch.empty_like(cache.pool_k).normal_(generator=gen) for _ in range(2)]
    block_bytes = cache.pool_k[0].numel() * cache.pool_k.element_size()
    shapes = (
        ("path", (cache.pool_k, cache.pool_v), sl),
        ("long", gen_pools, torch.from_numpy(rng.choice(NB, GATHER_LONG, replace=False).astype(np.int32)).to(dev)),
        ("random", gen_pools, torch.from_numpy(rng.choice(NB, GATHER_RANDOM, replace=False).astype(np.int32)).to(dev)),
    )
    for shape, (pk, pv), slots in shapes:
        clamped = paged_gather.clamp_slots(slots, NB)
        got = [paged_gather.gather_cuda(pk, slots), *paged_gather.gather_kv_cuda(pk, pv, slots)]
        want = [paged_gather.gather_plain(pk, slots), *paged_gather.gather_kv_plain(pk, pv, slots)]
        lib = [pk.index_select(0, clamped), pk.index_select(0, clamped), pv.index_select(0, clamped)]
        torch.cuda.synchronize()
        gerr = 0.0
        for a, b, c in zip(got, want, lib, strict=True):
            assert a.shape == b.shape and a.dtype == b.dtype
            gerr = max(gerr, float((a.float() - b.float()).abs().max()))
            if not (torch.equal(a.view(torch.int16), b.view(torch.int16)) and torch.equal(c.view(torch.int16), b.view(torch.int16))):
                raise AssertionError(f"kernel paged_gather disagrees with its plain version ({shape}, {gerr})")
        del got, want, lib
        one = lambda: paged_gather.gather_cuda(pk, slots)  # noqa: E731
        pair = lambda: paged_gather.gather_kv_cuda(pk, pv, slots)  # noqa: E731
        t = {
            "ms": time_ms(torch, one), "plain_ms": time_ms(torch, lambda: paged_gather.gather_plain(pk, slots)),
            "library_ms": time_ms(torch, lambda: pk.index_select(0, clamped)),
            "cold_ms": time_ms(torch, one, cold=True),
            "library_cold_ms": time_ms(torch, lambda: pk.index_select(0, clamped), cold=True),
            "pair_ms": time_ms(torch, pair),
            "pair_plain_ms": time_ms(torch, lambda: paged_gather.gather_kv_plain(pk, pv, slots)),
            "pair_library_ms": time_ms(torch, lambda: (pk.index_select(0, clamped), pv.index_select(0, clamped))),
            "pair_cold_ms": time_ms(torch, pair, cold=True),
            "pair_library_cold_ms": time_ms(torch, lambda: (pk.index_select(0, clamped), pv.index_select(0, clamped)), cold=True),
        }
        n = int(slots.numel())
        nbytes = 2 * n * block_bytes + 4 * n
        bound_ms, bound_by = bound(nbytes, 0)
        pair_bound_ms = bound(2 * nbytes - 4 * n, 0)[0]
        plans = {k: paged_gather.launch_plan(block_bytes, n, k, build.sm_count(dev.index or 0), True)._asdict()
                 for k in (1, 2)}
        emit({"phase": "kernel", "kernel": "paged_gather", "equal": True, "max_abs_err": gerr, "shape": shape, "slots": n,
              "block_bytes": block_bytes, **t, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
              "pair_bound_ms": pair_bound_ms, "gb_per_s": nbytes / t["ms"] / 1e6,
              "pair_gb_per_s": (2 * nbytes - 4 * n) / t["pair_ms"] / 1e6, "plan": plans[1], "pair_plan": plans[2]})
        if shape == "path":
            kernels["paged_gather"] = {
                "name": "paged_gather", "route": "cuda", "source": "src/repro_torch/csrc/paged_gather.cu",
                "replaces": "src/repro/kernels/paged_gather.py:21", "launches": launches["paged_gather"],
                "max_abs_err": gerr, **{k: t[k] for k in ("ms", "plain_ms")}, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": t["library_ms"],
                **{k: t[k] for k in ("cold_ms", "pair_ms", "pair_plain_ms", "pair_library_ms", "pair_cold_ms")},
                "pair_bound_ms": pair_bound_ms,
            }
    del layer, cache, gen_pools, kv
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ main


def main() -> int:
    torch = _setup()

    from repro_torch.core import DPAStore, datasets
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build_s = build.build_all()
    for name in build.SOURCES:
        build.lib(name)
    emit({
        "phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "numpy": np.__version__, "kernel_build_s": build_s,
    })

    # ---- the main-path store -----------------------------------------------
    rng = np.random.default_rng(SEED)
    W = WAVE
    n_upd = max(1, round(W * 5 / 95))
    t0 = time.perf_counter()
    keys = datasets.sparse(N_KEYS, seed=SEED)
    vals = keys ^ np.uint64(0x5DEECE66D)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = DPAStore(keys, vals, device=dev)
    torch.cuda.synchronize()
    store_build_s = time.perf_counter() - t0
    oracle = Oracle(keys, vals)
    n_draw = W * (ROUNDS + 11) + n_upd * (ROUNDS + 1)
    zipf = keys[datasets.zipf_indices(keys.size, n_draw, alpha=ZIPF, seed=SEED)]
    zpos = 0

    def draw(n):
        nonlocal zpos
        zpos += n
        assert zpos <= zipf.size, "draw budget exceeded"
        return zipf[zpos - n : zpos]

    def do_get(q):
        v, f = st.get(q)
        oracle.check_get(q, v, f)

    def do_update(n):
        ks = draw(n)
        vs = rng.integers(0, 2**64, ks.size, dtype=np.uint64)
        assert (st.put(ks, vs) == 0).all()
        oracle.put(ks, vs)

    # warm-up: buffered writes, point-cache and anchor-cache admits
    do_get(draw(W))
    do_update(n_upd)
    do_get(draw(W))
    warm_starts = draw(W)
    oracle.check_range(warm_starts, 10, st.range(warm_starts, limit=10))

    # ---- 2. kernels against their plain versions ---------------------------
    kernels = {}
    L, ML = 10 + 4 * st.cfg.ib_cap, 4
    one = torch.zeros(1, device=dev)
    floor = {"launch_floor_ms": time_ms(torch, lambda: one.fill_(0)),
             "launch_floor_cold_ms": time_ms(torch, lambda: one.fill_(0), cold=True)}
    q2 = draw(W)
    for name, (kern, plain, source, replaces, cost) in kernel_cases(torch, st, q2, L, ML).items():
        got, want = kern(), plain()
        err = max_abs_err(torch, name, got, want)
        ms, plain_ms = time_ms(torch, kern), time_ms(torch, plain)
        nbytes, nops = cost(got)
        bound_ms, bound_by = bound(nbytes, nops)
        kernels[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        }
        extra = {}
        if name == "get":  # B1: also from a cold L2, and the launch plan the wave got
            kernels[name]["cold_ms"] = extra["cold_ms"] = time_ms(torch, kern, cold=True)
            extra["plan"] = get_plan(torch, st, W)
        elif name.startswith("cache_probe"):  # B2: the same, the wave's shares and the launch floor
            extra = {"cold_ms": time_ms(torch, kern, cold=True), **probe_wave(torch, st, q2, int(name[-1])),
                     "hit": float(got[0].float().mean()), **floor}
            kernels[name].update(extra)
        emit({"phase": "kernel", "kernel": name, "equal": True, "ms": ms, "plain_ms": plain_ms,
              "bytes": nbytes, "ops": nops, "bound_ms": bound_ms, "bound_by": bound_by, **extra,
              "shapes": {"requests": W, "depth": st.depth, "L": L if name == "range_walk" else None}})
    del got, want

    # ---- 3. the main path --------------------------------------------------
    build.reset_launches()
    s0 = dataclasses.replace(st.stats)
    get_s = get_n = range_s = range_n = 0.0

    def timed_get(q):
        nonlocal get_s, get_n
        t = time.perf_counter()
        v, f = st.get(q)
        get_s += time.perf_counter() - t
        get_n += q.size
        oracle.check_get(q, v, f)

    def timed_range(starts, limit, max_leaves=4):
        nonlocal range_s, range_n
        t = time.perf_counter()
        res = st.range(starts, limit=limit, max_leaves=max_leaves)
        range_s += time.perf_counter() - t
        range_n += starts.size
        oracle.check_range(starts, limit, res)
        return res

    torch.cuda.reset_peak_memory_stats()
    for _ in range(ROUNDS):
        timed_get(draw(W))
        do_update(n_upd)
    dels = rng.choice(keys, 4096, replace=False)
    assert (st.delete(dels) == 0).all()
    oracle.delete(dels)
    timed_get(np.concatenate([dels[:2048], draw(W - 2048)]))
    starts = draw(W)
    timed_range(starts, 10)
    timed_range(starts, 10)  # repeated starts: anchor-cache hits
    r100 = timed_range(draw(W // 4), 100, max_leaves=1)
    assert r100.rounds > 1, "the limit-100 wave must take several rounds"
    t = time.perf_counter()
    st.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t
    timed_get(np.concatenate([dels[2048:], draw(W - 2048)]))
    timed_range(draw(W), 10)
    launches = dict(build.launches)
    for k in kernels:  # the kernels of this path (phase 2); B4 serves the paged path
        assert launches[k] > 0, f"kernel {k} was not launched on the main path"
        kernels[k]["launches"] = launches[k]
    stats = st.stats
    assert stats.flush_cycles == stats.stitch_applies, "batched flush: one apply per cycle"
    assert stats.cache_hits > s0.cache_hits and stats.scan_hits > s0.scan_hits
    emit({
        "phase": "main", "keys": N_KEYS, "wave": W, "depth": st.depth,
        "inner_nodes_per_level": inner_nodes_per_level(st.image),
        "leaves_pool": int(st.tree.leaf_count.shape[0]), "slots_pool": int(st.tree.hbm_keys.shape[0]),
        "gen_s": gen_s, "store_build_s": store_build_s,
        "get_mops": get_n / get_s / 1e6, "range_mops": range_n / range_s / 1e6,
        "get_requests": int(get_n), "range_requests": int(range_n), "range100_rounds": r100.rounds,
        "flush_s": flush_s, "launches": launches,
        "cache_hits": stats.cache_hits - s0.cache_hits, "scan_hits": stats.scan_hits - s0.scan_hits,
        "flush_cycles": stats.flush_cycles, "stitch_applies": stats.stitch_applies,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "oracle": "all GET and RANGE answers equal",
    })
    # ---- where one wave's time goes (torch.profiler) ------------------------
    profile_wave(torch, "get", W, lambda: st.get(draw(W)))
    profile_wave(torch, "range", W, lambda: st.range(draw(W), limit=10))

    # ---- the serving front end on the same store -----------------------------
    frontend_phase(torch, st, oracle, keys)
    del st, oracle, zipf
    torch.cuda.empty_cache()

    # ---- the versioned phase and the tenant deployment, on the same keys -----
    versioned_phase(torch, dev, keys, vals)
    tenants_phase(torch, dev, keys)
    dist_ctx = sharded_phase(torch, dev, keys, vals, smi)
    del keys, vals
    dist_phase(torch, dev, dist_ctx, smi)
    del dist_ctx
    torch.cuda.empty_cache()

    # ---- 4. the card against the CPU ---------------------------------------
    pkeys = datasets.sparse(PARITY_KEYS, seed=SEED + 1)
    pvals = pkeys ^ np.uint64(0xABCD)
    stores = [DPAStore(pkeys, pvals, device=d) for d in (dev, "cpu")]
    prng = np.random.default_rng(SEED + 2)
    pz = pkeys[datasets.zipf_indices(pkeys.size, 200_000, alpha=ZIPF, seed=SEED + 3)]
    live = pkeys.copy()

    n_ops = 0
    for step in range(12):
        q = np.concatenate([prng.choice(pz, 4096), prng.integers(0, 2**63, 512, dtype=np.uint64)])
        _same([s.get(q) for s in stores], f"get {step}")
        newk = prng.integers(0, 2**63, 1500, dtype=np.uint64)
        newv = prng.integers(0, 2**64, newk.size, dtype=np.uint64)
        _same([s.put(newk, newv) for s in stores], f"put new {step}")
        live = np.concatenate([live, newk])
        oldk = prng.choice(pz, 1500)
        _same([s.put(oldk, oldk ^ np.uint64(step + 1)) for s in stores], f"put old {step}")
        dk = prng.choice(live, 600)
        _same([s.delete(dk) for s in stores], f"delete {step}")
        starts = np.concatenate([prng.choice(pz, 1024), prng.choice(live, 256)])
        limit, ml = [(10, 4), (40, 1), (100, 2)][step % 3]
        _same([s.range(starts, limit=limit, max_leaves=ml) for s in stores], f"range {step}")
        kmax = starts + np.uint64(2**44)
        _same([s.range(starts, limit=limit, k_max=kmax, max_leaves=ml) for s in stores], f"range k_max {step}")
        rs = [s.range_with_state(starts[:256], limit=64, max_leaves=1, max_rounds=1) for s in stores]
        _same(rs, f"bounded {step}")
        m = rs[0].truncated
        if m.any():
            _same([s.range_with_state(starts[:256][m], limit=64, max_leaves=1, start_leaves=r.cursor_leaf[m])
                  for s, r in zip(stores, rs)], f"resumed {step}")
        if step % 4 == 3:
            _same([np.array(s.flush()) for s in stores], f"flush {step}")
        n_ops += 8
    _same([s.items() for s in stores], "items")
    a, b = stores
    _same_state(a, b)
    emit({"phase": "parity", "keys": PARITY_KEYS, "op_waves": n_ops, "identical": True,
          "flush_cycles": a.stats.flush_cycles, "cache_hits": a.stats.cache_hits,
          "scan_hits": a.stats.scan_hits, "range_rounds_in_mesh": a.stats.range_rounds_in_mesh})
    del stores, a, b
    versioned_parity(torch, dev)
    frontend_parity(torch, dev)
    sharded_parity(torch, dev)
    dist_parity(torch, dev)
    kv_dryrun_phase(torch, dev)
    serve_cli_phase(torch, dev)

    paged_phase(torch, dev, kernels)

    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
