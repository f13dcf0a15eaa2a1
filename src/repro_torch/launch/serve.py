"""Serving launcher of the port: run the DPA-Store KV service, or an LM.

    # an LM (no --kv): batched prefill + greedy decode over a dense cache,
    # weights drawn from a seed (glm4-9b at full width: 18.8 GB of bf16)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --batch 4 --prompt 1024 --steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --reduced --steps 4 --device cpu

    # the paper's workload: a KV service handling GET/UPDATE/RANGE waves
    PYTHONPATH=src python -m repro_torch.launch.serve --kv --n-keys 100000 --waves 20

    # RANGE knobs: scan-anchor cache on/off, leaves per continuation round
    PYTHONPATH=src python -m repro_torch.launch.serve --kv --no-scan-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --kv --max-leaves 2

    # point-in-time versioned reads + TTL expiry: pin a pre-run snapshot,
    # write the UPDATE waves with a deadline, sweep the expired keys at
    # exit, then re-verify the pinned snapshot bitwise through as_of
    PYTHONPATH=src python -m repro_torch.launch.serve --kv --retain-epochs 64 --ttl 4

    # multi-tenant front end: 4 tenant namespaces through the deadline
    # wave scheduler, tenant 0 rate-limited to 2048 keys/tick at half QoS
    # weight (zipf request skew makes tenant 0 the noisy neighbour)
    PYTHONPATH=src python -m repro_torch.launch.serve --kv --tenants 4 \\
        --tenant-rate 0:2048 --tenant-weights 0:0.5 --max-delay 4

    # sharded: hash tier (RANGE broadcasts) vs range tier (scatter-gather)
    PYTHONPATH=src python -m repro_torch.launch.serve --kv --partition hash --shards 4
    PYTHONPATH=src python -m repro_torch.launch.serve --kv --partition range --shards 4

    # online rebalancing: skewed fresh inserts + live boundary refits
    PYTHONPATH=src python -m repro_torch.launch.serve --kv --partition range \\
        --shards 4 --rebalance --rebalance-every 4

    # replicated shard groups: R replicas per slice, synchronous write
    # fan-out, mid-run primary kill + failover + re-replication
    PYTHONPATH=src python -m repro_torch.launch.serve --kv --partition range \\
        --shards 4 --replication 2 --kill-primary-at 8

    # elastic scale-out: live reshard 2 -> 4 mid-run, then persist an
    # epoch-consistent, shard-count-independent snapshot at exit
    PYTHONPATH=src python -m repro_torch.launch.serve --kv --partition range \\
        --shards 2 --reshard-to 4 --snapshot-dir /tmp/kv_snap

The store (every shard of a sharded tier) and the LM run on the CUDA card;
``--device cpu`` runs the plain-torch path on the CPU.  All shards share
the one device.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from ..configs import ARCHS, reduced
from ..core import DPAStore, EpochRetiredError, TreeConfig, perfmodel
from ..core import keys as keymod
from ..core.datasets import sparse, zipf_indices
from ..core.scancache import ScanCacheConfig
from ..core.spans import format_totals
from ..distributed.kvshard import ShardedDPAStore
from ..distributed.snapshot import save_snapshot
from ..device import resolve_device
from ..models import lm
from ..serving.admission import ADMIT_RETRY, AdmissionController, TenantPolicy
from ..serving.engine import Engine, KVWaveDriver, ServeConfig
from ..serving.pipeline import PipelinedStore

def device_name(device: torch.device) -> str:
    """The name the throughput lines print for the store's device."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU"


def _parse_tenant_map(spec: str) -> dict:
    """``'100'`` -> every tenant; ``'0:200,3:50'`` -> per-tenant overrides.

    A bare number is stored under key ``-1`` (the all-tenants default)."""
    out = {}
    if not spec:
        return out
    for part in spec.split(","):
        if ":" in part:
            tid, v = part.split(":", 1)
            out[int(tid)] = float(v)
        else:
            out[-1] = float(part)
    return out


def tenant_slabs(base: np.ndarray, n_tenants: int, bits: int = keymod.TENANT_BITS):
    """Shift u64 ``base`` keys right by ``bits`` (into the local namespace),
    deal the distinct results round-robin across tenants as tenant-local
    keys and encode them into the tenants' slabs of one ordered key space.
    Returns (local keys per tenant, sorted encoded keys, values)."""
    shifted = base >> np.uint64(bits)
    if not (shifted[1:] >= shifted[:-1]).all():  # sorted keys (the datasets') skip the sort
        shifted = np.sort(shifted)
    base = shifted[np.r_[True, shifted[1:] != shifted[:-1]]] if shifted.size else shifted
    local = [base[t::n_tenants] for t in range(n_tenants)]
    # each slab is sorted and the slabs ascend with the tenant id, so their
    # concatenation is already the sorted key space
    enc = np.concatenate([keymod.encode_tenant(t, lk, bits) for t, lk in enumerate(local)])
    return local, enc, enc ^ np.uint64(0xC0FFEE)


def tenant_weights(n_tenants: int) -> np.ndarray:
    """Zipf skew over tenants: tenant 0 is the noisy neighbour."""
    tw = np.arange(1, n_tenants + 1, dtype=np.float64) ** (-1.5)
    return tw / tw.sum()


def tenant_request(rng, local, tw, wave_size: int, w: int):
    """One client request of the multi-tenant loop's mix at loop iteration
    ``w``: ``(op, tenant, keys, vals)`` — 60 % GET and 20 % PUT of
    ``wave_size // 4`` local keys, 20 % RANGE of 32 starts (limit 10)."""
    t = int(rng.choice(len(local), p=tw))
    lk = local[t]
    q = lk[rng.integers(0, len(lk), wave_size // 4)]
    r = rng.random()
    if r < 0.6:
        return "get", t, q, None
    if r < 0.8:
        return "put", t, q, q ^ np.uint64(w + 1)
    return "range", t, q[:32], None


def build_store(args, keys, vals, retain_epochs: int = 0):
    """The store of the tier ``--partition`` names: one ``DPAStore``, or a
    ``ShardedDPAStore`` of ``--shards`` (and ``--replication``) on one
    device."""
    scan_cfg = ScanCacheConfig() if args.scan_cache else None
    if args.partition == "single":
        return DPAStore(
            keys, vals, TreeConfig(), scan_cache_cfg=scan_cfg, retain_epochs=retain_epochs, device=args.device
        )
    return ShardedDPAStore(
        keys,
        vals,
        args.shards,
        TreeConfig(),
        partition=args.partition,
        scan_cache_cfg=scan_cfg,
        replication=args.replication,
        retain_epochs=retain_epochs,
        device=args.device,
    )


def serve_kv_tenants(args):
    """Multi-tenant serving loop: every request rides the deadline wave
    scheduler (:class:`repro_torch.serving.engine.KVWaveDriver`) —
    per-tenant namespaces in one ordered key space, token-bucket
    admission, weighted wave packing — over the same single/hash/range
    tiers as ``serve_kv``."""
    T = args.tenants
    bits = keymod.TENANT_BITS
    local, enc, vals = tenant_slabs(sparse(args.n_keys, seed=1), T, bits)
    store = build_store(args, enc, vals)
    rates = _parse_tenant_map(args.tenant_rate)
    weights = _parse_tenant_map(args.tenant_weights)
    adm = None
    if rates or weights:
        adm = AdmissionController(
            {
                t: TenantPolicy(
                    rate=rates.get(t, rates.get(-1, 0.0)),
                    weight=weights.get(t, weights.get(-1, 1.0)),
                )
                for t in range(T)
            }
        )
    drv = KVWaveDriver(
        store,
        queue_depth=args.queue_depth,
        wave_size=args.wave_size,
        max_delay=args.max_delay,
        admission=adm,
        tenant_bits=bits,
        max_leaves=args.max_leaves,
    )
    rng = np.random.default_rng(0)
    tw = tenant_weights(T)
    retries = {t: 0 for t in range(T)}
    t0 = time.time()
    served = 0
    for w in range(args.waves):
        for _ in range(max(T, 2)):
            op, t, q, v = tenant_request(rng, local, tw, args.wave_size, w)
            if op == "range":
                drv.request("range", q, limit=10, tenant=t)
            else:
                drv.request(op, q, v, tenant=t)
            served += q.size
        drv.tick()
        if (w + 1) % 4 == 0:
            for rep in drv.drain():
                if rep.status == ADMIT_RETRY:
                    retries[rep.tenant] += 1
    for rep in drv.drain():
        if rep.status == ADMIT_RETRY:
            retries[rep.tenant] += 1
    dt = time.time() - t0
    s = drv.scheduler_summary()
    print(
        f"[serve-kv] {T} tenants, {served} requested keys in {dt:.2f}s "
        f"({served/dt/1e3:.1f} kOPS submitted on {device_name(store.device)})"
    )
    print(
        f"[serve-kv] scheduler: {s['waves']} waves "
        f"(seals: size={s['seals']['size']} deadline={s['seals']['deadline']} "
        f"kind={s['seals']['kind']} drain={s['seals']['drain']}), "
        f"cross-tenant leaks={s['leaked_rows']} (must be 0)"
    )
    for t in range(T):
        srv = s["rows_served"].get(t, 0)
        line = f"[serve-kv]   tenant {t}: {srv} keys served, {retries[t]} retries"
        if adm is not None:
            a = adm.summary().get(t)
            if a is not None:
                line += (
                    f" (rate={a['rate']:.0f}/tick weight={a['weight']:.2f} "
                    f"admitted={a['admitted_keys']} "
                    f"refused={a['retried_keys']} keys)"
                )
        print(line)
    print(f"[serve-kv] pipeline: {drv.pipeline_summary()}")


def serve_kv(args):
    keys = sparse(args.n_keys, seed=1)
    vals = keys ^ np.uint64(0xC0FFEE)
    store = build_store(args, keys, vals, retain_epochs=args.retain_epochs)
    # queue_depth > 1: wave N+1 builds and launches while wave N's results
    # drain; barrier ops (rebalance, failover, reshard, flush, sweep,
    # snapshots) drain the pipeline first.  Every op below goes through
    # ``kv`` so in-flight waves stay consistent.
    pipe = PipelinedStore(store, queue_depth=args.queue_depth) if args.queue_depth > 1 else None
    kv = pipe if pipe is not None else store
    pending = []  # (op kind, ticket) of in-flight waves, submission order
    range_hits = 0

    def collect(force=False):
        nonlocal range_hits
        keep = 0 if force else max(args.queue_depth - 1, 0)
        while len(pending) > keep:
            kind, t = pending.pop(0)
            res = pipe.result(t)
            if kind == "get":
                assert res[1].all()
            elif kind == "range":
                range_hits += int(res.counts.sum())

    snap = None
    if args.retain_epochs > 0:
        # pin the pre-run state; re-read it through as_of at exit after
        # the full churn (updates, rebalances, reshards, TTL sweeps)
        snap = kv.snapshot_epoch()
        frozen_probe = keys[:: max(len(keys) // 256, 1)][:256]
        frozen_vals = frozen_probe ^ np.uint64(0xC0FFEE)
    idx = zipf_indices(len(keys), args.waves * args.wave_size, alpha=0.99, seed=2)
    rebalancing = args.rebalance and args.partition == "range"
    replicated = args.partition == "range" and args.replication > 1
    fresh_base = keys.max()
    t0 = time.time()
    served = 0
    recovery_s = None
    tracing = (
        pipe.pipeline.trace(args.profile_dir) if pipe is not None and args.profile_dir else contextlib.nullcontext()
    )
    with tracing:
        for w in range(args.waves):
            q = keys[idx[w * args.wave_size : (w + 1) * args.wave_size]]
            kind = w % 4
            if kind < 2:  # GET-heavy mix
                if pipe is not None:
                    pending.append(("get", pipe.submit_get(q)))
                else:
                    _, found = kv.get(q)
                    assert found.all()
            elif kind == 2:
                if rebalancing:  # sequential fresh-insert storm: the
                    # adversarial edge workload a load-time boundary fit
                    # cannot absorb
                    n_new = args.wave_size // 4
                    newk = fresh_base + np.uint64(1) + np.arange(n_new, dtype=np.uint64) * np.uint64(3)
                    fresh_base = newk.max()
                    upd = newk
                else:  # UPDATE
                    upd = q[: args.wave_size // 4]
                if args.ttl:  # expiring write: deadline bookkeeping rides the serial path
                    kv.put(upd, upd, ttl=args.ttl)
                elif pipe is not None:
                    pending.append(("put", pipe.submit_put(upd, upd)))
                else:
                    kv.put(upd, upd)
            else:  # RANGE (scatter-gather on the range tier; broadcast on
                # hash; zipf-repeated start keys exercise the anchor cache)
                if pipe is not None:
                    pending.append(("range", pipe.submit_range(q[:64], 10, max_leaves=args.max_leaves)))
                else:
                    result = kv.range(q[:64], limit=10, max_leaves=args.max_leaves)
                    range_hits += int(result.counts.sum())
            if pipe is not None:
                collect()  # deliver all but the in-flight window, in order
            if replicated and args.kill_primary_at and w + 1 == args.kill_primary_at:
                promoted = kv.kill_replica(0)  # crash shard 0's primary
                # (a barrier op: the pipeline drains before the epoch flip)
                print(
                    f"[serve-kv] wave {w}: killed shard 0 primary — replica "
                    f"{promoted} promoted under failover epoch "
                    f"{store.boundary_epoch}; serving continues"
                )
            elif replicated and args.kill_primary_at and w == args.kill_primary_at:
                # one wave later: the old epoch's in-flight requests have
                # drained — retire it and re-replicate the dead slot
                kv.retire_failover()
                t_rec = time.time()
                plan = kv.recover_replicas()
                recovery_s = time.time() - t_rec
                print(
                    f"[serve-kv] wave {w}: re-replicated {plan.n_rebuilds} "
                    f"replica(s) in {recovery_s:.2f}s — group back in sync"
                )
            if (
                args.reshard_to
                and args.partition == "range"
                and w + 1 == args.waves // 2
                and args.reshard_to != kv.n_shards
            ):
                # live reshard at the halfway mark (a barrier op: in-flight
                # waves drain under the epoch they were admitted with)
                t_rs = time.time()
                report = kv.reshard(args.reshard_to)
                print(
                    f"[serve-kv] wave {w}: resharded "
                    f"{report['resharded_keys']} keys -> "
                    f"{report['n_shards']} shards in "
                    f"{time.time() - t_rs:.2f}s (occupancy spread "
                    f"{report['ratio']:.2f}); serving continues"
                )
            if rebalancing and (w + 1) % args.rebalance_every == 0:
                report = kv.maybe_rebalance()
                if report is not None:
                    print(
                        f"[serve-kv] wave {w}: rebalanced "
                        f"{report['migrated_keys']} keys across "
                        f"{report['moves']} slice moves "
                        f"(occupancy spread -> {report['ratio']:.2f})"
                    )
            served += args.wave_size
        if pipe is not None:
            collect(force=True)
    dt = time.time() - t0
    if pipe is not None:
        s = pipe.pipeline_summary()
        roof = perfmodel.pipelined_wave_mops(
            args.wave_size, s["issue_us_per_wave"], s["drain_us_per_wave"], args.queue_depth
        )
        print(
            f"[serve-kv] pipeline: queue_depth={args.queue_depth} "
            f"waves={s['waves']} "
            f"issue {s['issue_us_per_wave']:.0f}us + drain "
            f"{s['drain_us_per_wave']:.0f}us per wave -> host roofline "
            f"{roof:.3g} MOPS"
            + (f" (trace -> {args.profile_dir})" if args.profile_dir else "")
        )
        print(f"[serve-kv] spans: {format_totals(pipe.span_totals())}")
    print(f"[serve-kv] {served} requests in {dt:.2f}s ({served/dt/1e3:.1f} kOPS on {device_name(store.device)})")
    if args.partition == "single":
        st = store.stats
        hit = st.scan_hits / max(st.scan_probes, 1)
        print(
            f"[serve-kv] scan-anchor cache: {st.scan_hits}/{st.scan_probes} "
            f"descents skipped ({100*hit:.0f}% hit), "
            f"{st.scan_invalidated} anchors invalidated by restitch, "
            f"{st.range_rounds_in_mesh} continuation rounds in-mesh vs "
            f"{st.range_reissue_rounds} host re-issue rounds"
        )
        print(f"[serve-kv] RANGE returned {range_hits} entries total")
        print(f"[serve-kv] stats: {st}")
    else:
        fan = store.range_subqueries / max(store.range_requests, 1)
        tot = store.stats_totals()
        hit = tot.get("scan_hits", 0) / max(tot.get("scan_probes", 0), 1)
        print(
            f"[serve-kv] partition={args.partition} shards={store.n_shards} "
            f"range fan-out={fan:.2f} sub-queries/request, "
            f"{store.range_rounds_in_mesh} continuation rounds in-mesh, "
            f"{store.range_reissues} host re-issues (steady state: 0 — the "
            f"device loop resumes truncated lanes itself; hash tier "
            f"broadcasts to all {store.n_shards})"
        )
        if store.reshards:
            print(
                f"[serve-kv] elastic: {store.reshards} reshard(s), "
                f"{store.resharded_keys} keys redistributed, now serving "
                f"{store.n_shards} shards at boundary epoch "
                f"{store.boundary_epoch}"
            )
        if args.partition == "range":
            spread = store.occupancy_spread(flush=True)
            print(
                f"[serve-kv] rebalance: {store.rebalances} cycles "
                f"({store.rebalances_aborted} aborted), "
                f"{store.migrated_keys} keys migrated, boundary epoch "
                f"{store.boundary_epoch}, occupancy spread "
                f"{spread['ratio']:.2f} (min {spread['min']} / "
                f"max {spread['max']})"
            )
        if replicated:
            rec = f", recovery {recovery_s:.2f}s" if recovery_s is not None else ""
            print(
                f"[serve-kv] replication: R={args.replication}, write "
                f"amplification {store.write_amplification:.2f}x, "
                f"{store.acked_writes}/{store.client_writes} writes acked "
                f"durable group-wide, {store.failovers} failover(s), "
                f"{store.recoveries} replica(s) rebuilt{rec}"
            )
        print(f"[serve-kv] RANGE returned {range_hits} entries total")
        print(f"[serve-kv] scan-anchor cache: {100*hit:.0f}% descent-skip hit rate across shards")
        print(f"[serve-kv] shard stats totals: {tot}")
    if args.ttl:
        kv.ttl.tick(args.ttl)  # advance the logical expiry clock past
        # every deadline the loop wrote (reads filter lazily until now)
        t_sw = time.time()
        reclaimed = kv.ttl_sweep()
        print(
            f"[serve-kv] ttl: {reclaimed} expired keys physically "
            f"reclaimed in {time.time() - t_sw:.2f}s (ttl={args.ttl} "
            f"ticks; expiry is a versioned event — pre-expiry as_of "
            f"epochs still serve the keys)"
        )
    if snap is not None:
        try:
            v, f = kv.get(frozen_probe, as_of=snap)
            ok = bool(np.asarray(f).all() and np.array_equal(np.asarray(v, dtype=np.uint64), frozen_vals))
            print(
                f"[serve-kv] versioned: as_of={snap} over "
                f"{frozen_probe.size} pre-run keys after the full churn "
                f"-> {'bitwise match' if ok else 'MISMATCH'} "
                f"(retain_epochs={args.retain_epochs})"
            )
        except EpochRetiredError:
            print(
                f"[serve-kv] versioned: snapshot epoch {snap} aged out of "
                f"the {args.retain_epochs}-cycle retention window — raise "
                f"--retain-epochs to keep longer-lived snapshots readable"
            )
    if args.snapshot_dir:
        t_sn = time.time()
        step = save_snapshot(kv, args.snapshot_dir)
        print(
            f"[serve-kv] snapshot: epoch-consistent ordered run saved as "
            f"step {step} under {args.snapshot_dir} in "
            f"{time.time() - t_sn:.2f}s — restorable at ANY shard count "
            f"(repro_torch.distributed.snapshot.restore_store)"
        )


def serve_lm(args):
    """The reference's ``serve_lm``: random weights from seed 0, a random
    prompt, greedy generation; prints prefill ms, decode ms a step and
    tokens/s on the host clock."""
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    params = lm.init(cfg, 0, device=dev)
    init_s = time.perf_counter() - t0
    eng = Engine(cfg, params, ServeConfig(max_len=args.prompt + args.steps + 8), device=dev)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt)).astype(np.int32)
    t0 = time.perf_counter()
    out = eng.generate(toks, args.steps)
    dt = time.perf_counter() - t0
    step_s = eng.timings["step_s"]
    step_ms = 1e3 * float(np.median(step_s)) if step_s else 0.0
    print(f"[serve-lm] {cfg.name} on {device_name(dev)}: {cfg.param_counts()[0]:,} params "
          f"drawn in {init_s:.2f}s")
    print(f"[serve-lm] generated {out.shape} tokens in {dt:.2f}s: prefill "
          f"{1e3 * eng.timings['prefill_s']:.2f} ms ({args.batch}x{args.prompt}), decode "
          f"{step_ms:.2f} ms a step (median), {out.size / dt:.1f} tokens/s")
    print(f"[serve-lm] sample: {out[0][:16].tolist()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kv", action="store_true")
    ap.add_argument(
        "--device",
        default=None,
        help="device of the store or the LM: the CUDA card unless given "
        "(without CUDA they raise); 'cpu' runs the plain-torch path",
    )
    ap.add_argument(
        "--partition",
        choices=["single", "hash", "range"],
        default="single",
        help="KV tier: one store, hash-sharded, or range-partitioned "
        "(quantile boundaries; RANGE scatter-gathers instead of broadcasting)",
    )

    def positive_int(v):
        iv = int(v)
        if iv < 1:
            raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
        return iv

    ap.add_argument("--shards", type=positive_int, default=4)

    ap.add_argument(
        "--scan-cache",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="scan-anchor cache: repeated RANGE(k_min) waves skip the "
        "learned-index descent and start at the cached leaf "
        "(--no-scan-cache disables; invalidated automatically on restitch)",
    )
    ap.add_argument(
        "--max-leaves",
        type=positive_int,
        default=4,
        help="leaves per RANGE wave; truncated scans resume from their "
        "continuation cursor, so results are exact for any value",
    )
    ap.add_argument(
        "--rebalance",
        action=argparse.BooleanOptionalAction,
        default=False,
        help="range tier only: replace the UPDATE waves with a sequential "
        "fresh-insert storm and let the planner refit boundaries + migrate "
        "slices online when the occupancy spread crosses its trigger",
    )
    ap.add_argument(
        "--rebalance-every",
        type=positive_int,
        default=4,
        help="waves between rebalance-planner probes (with --rebalance)",
    )
    ap.add_argument(
        "--replication",
        type=positive_int,
        default=1,
        help="range tier only: replicas per shard group (writes fan out "
        "synchronously to every in-sync replica; reads round-robin)",
    )
    ap.add_argument(
        "--kill-primary-at",
        type=int,
        default=0,
        help="with --replication > 1: crash shard 0's primary after this "
        "wave (0 = never) — a follower is promoted via a failover epoch "
        "and the dead slot is re-replicated one wave later",
    )
    ap.add_argument(
        "--reshard-to",
        type=int,
        default=0,
        help="range tier only: live-reshard the fleet to this shard count "
        "at the halfway wave (grow or shrink; 0 = never) — old-epoch waves "
        "drain over the retired generation while fresh requests route over "
        "the new one, zero acked writes lost",
    )
    ap.add_argument(
        "--snapshot-dir",
        default="",
        help="save an epoch-consistent, shard-count-independent snapshot "
        "of the store here at the end of the run (atomic checkpoint "
        "layout; restore onto any shard count via "
        "repro_torch.distributed.snapshot.restore_store)",
    )
    ap.add_argument(
        "--queue-depth",
        type=positive_int,
        default=2,
        help="in-flight request waves: 1 = serial (build, launch, block "
        "per wave), 2 = double-buffered (wave N+1 builds and launches "
        "while wave N drains — the default), higher = deeper pipelining; "
        "results are bitwise-identical at every depth",
    )
    ap.add_argument(
        "--retain-epochs",
        type=int,
        default=0,
        help="multi-version retention window in flush cycles: > 0 keeps "
        "superseded leaf versions addressable, enabling snapshot_epoch() "
        "+ get/range(as_of=E) point-in-time reads — the serve loop pins "
        "a pre-run snapshot and re-verifies it bitwise at exit; reads "
        "past the window raise EpochRetiredError (0 = no versioned reads)",
    )
    ap.add_argument(
        "--ttl",
        type=int,
        default=0,
        help="write the loop's UPDATE waves with this TTL (logical clock "
        "ticks): expired keys read as absent, then at exit the clock "
        "advances and ttl_sweep() physically reclaims them; pre-expiry "
        "as_of epochs still serve them (0 = writes never expire)",
    )
    ap.add_argument(
        "--profile-dir",
        default="",
        help="with --queue-depth > 1: record a torch.profiler trace of the "
        "serve loop (wave issue/drain spans included) into this directory",
    )
    ap.add_argument(
        "--tenants",
        type=positive_int,
        default=1,
        help="tenant namespaces (> 1 routes every request through the "
        "multi-tenant deadline wave scheduler: tenant-prefix keys in one "
        "ordered store, fair wave packing, per-tenant stats)",
    )
    ap.add_argument(
        "--tenant-rate",
        default="",
        help="token-bucket admission: keys/logical-tick, either one number "
        "for every tenant or 'tid:rate,tid:rate' overrides (e.g. "
        "'0:2048'); omitted/0 = unlimited; over-budget requests get an "
        "explicit RETRY, never a silent drop",
    )
    ap.add_argument(
        "--tenant-weights",
        default="",
        help="QoS wave-packing weights, same syntax as --tenant-rate "
        "(e.g. '0:0.5' halves tenant 0's share of each sealed wave)",
    )
    ap.add_argument(
        "--max-delay",
        type=positive_int,
        default=8,
        help="deadline (logical ticks) after which a forming wave seals "
        "even if it never reached --wave-size",
    )
    ap.add_argument("--n-keys", type=int, default=100_000)
    ap.add_argument("--waves", type=int, default=16)
    ap.add_argument("--wave-size", type=int, default=1024)
    # the LM mode (no --kv)
    ap.add_argument("--arch", default="glm4-9b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)
    if not args.kv:
        serve_lm(args)
    elif args.tenants > 1:
        serve_kv_tenants(args)
    else:
        serve_kv(args)


if __name__ == "__main__":
    main()
