"""Online rebalancing, replication, elastic reshard and the straggler
watchdog of the port against the JAX package, bitwise, on the CPU.

* The numpy pieces (``OwnershipTable``, ``plan_moves``, ``ReservoirSample``,
  ``RebalancePlanner``, the straggler ``Watchdog``, ``plan_replica_remesh``
  and ``plan_remesh`` over the port's ``configs.base.ArchConfig``) make the
  same decisions as the reference on seeded streams.
* Twin facades (the port's ``ShardedDPAStore(device="cpu")`` and the
  reference's) fed the same calls give the same answers, ``items()`` and
  counters through a skew storm with rebalancing, forced mid-migration
  interleavings, chain compaction across rebalance cycles, primary and
  follower kills with retire and recovery, reshards 2->4 and 4->3 (one
  through ``PipelinedStore`` as a barrier) and a watchdog evacuation driven
  through ``wave_time_hook``.

One key set and ``TreeConfig`` per scenario keep the reference's compiled
shapes few; the reference's own tests are ``tests/test_rebalance.py``,
``tests/test_elastic_reshard.py`` and ``tests/test_checkpoint_elastic.py``."""

import dataclasses

import numpy as np
import pytest

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.core import TreeConfig as JaxTreeConfig
from repro.core.datasets import sparse, zipf_indices
from repro.distributed import elastic as jelastic
from repro.distributed import kvshard as jkv
from repro.distributed import rebalance as jreb
from repro.distributed import straggler as jstraggler
from repro_torch.configs.base import ArchConfig
from repro_torch.core import TreeConfig
from repro_torch.distributed import elastic, kvshard, rebalance, straggler
from repro_torch.serving.pipeline import PipelinedStore

from test_torch_kvshard import assert_same, assert_same_facade

pytestmark = pytest.mark.timeout(300)

GROWTH = 16.0


class Twin:
    """The port's facade and the reference's, fed the same calls: every
    return value (or the exception type) must be the same."""

    def __init__(self, keys, vals, n_shards, rebalance_cfg="default", **kw):
        rcfg = lambda mod: rebalance_cfg if rebalance_cfg in ("default", None) else mod.RebalanceConfig(  # noqa: E731
            **dataclasses.asdict(rebalance_cfg))
        self.t = kvshard.ShardedDPAStore(keys, vals, n_shards, TreeConfig(growth=GROWTH), partition="range",
                                         cache_cfg=None, rebalance_cfg=rcfg(rebalance), device="cpu", **kw)
        self.j = jkv.ShardedDPAStore(keys, vals, n_shards, JaxTreeConfig(growth=GROWTH), partition="range",
                                     cache_cfg=None, rebalance_cfg=rcfg(jreb), **kw)

    def __call__(self, name, *args, **kw):
        try:
            a = getattr(self.t, name)(*args, **kw)
        except Exception as e:  # the reference must refuse the same call
            with pytest.raises(type(e)):
                getattr(self.j, name)(*args, **kw)
            raise
        b = getattr(self.j, name)(*args, **kw)
        assert_same(a, b, (name,))
        return a

    def reads(self, q, epoch=None, limit=10, max_leaves=4):
        self("get", q, epoch=epoch)
        self("range", q, limit, max_leaves=max_leaves, epoch=epoch)

    def check(self, ctx=()):
        assert_same_facade(self.t, self.j, ctx)


# ---------------------------------------------------------------------------
# numpy pieces
# ---------------------------------------------------------------------------


def test_ownership_plan_moves_reservoir_and_planner_equal_the_reference():
    rng = np.random.default_rng(1)
    for trial in range(20):
        n = int(rng.integers(2, 7))
        old = np.sort(rng.integers(0, 2**64 - 1, n - 1, dtype=np.uint64))
        new = np.sort(rng.integers(0, 2**64 - 1, n - 1, dtype=np.uint64))
        assert_same(rebalance.plan_moves(old, new), jreb.plan_moves(old, new), ("moves", trial))
        R = int(rng.integers(1, 4))
        t, j = rebalance.OwnershipTable(old, n_replicas=R), jreb.OwnershipTable(old, n_replicas=R)
        q = rng.integers(0, 2**64 - 1, 64, dtype=np.uint64)
        t.install(new)
        j.install(new)
        for e in (None, t.epoch - 1, t.epoch):
            np.testing.assert_array_equal(t.route(q, epoch=e), j.route(q, epoch=e))
            np.testing.assert_array_equal(t.lower_bounds(e), j.lower_bounds(e))
            np.testing.assert_array_equal(t.upper_bounds(e), j.upper_bounds(e))
        t.retire_previous()
        j.retire_previous()
        with pytest.raises(KeyError):
            t.route(q, epoch=t.epoch - 1)
        if R > 1:
            g = int(rng.integers(0, n))
            assert t.fail_replica(g, int(t.primary[g])) == j.fail_replica(g, int(j.primary[g]))
            np.testing.assert_array_equal(t.primary_for(t.epoch - 1), j.primary_for(j.epoch - 1))
            t.retire_previous()
            j.retire_previous()
            t.restore_replica(g, 0)
            j.restore_replica(g, 0)
        for f in ("current", "primary", "in_sync", "epoch"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    # the reservoir and the planner over a seeded key stream
    cfg = dict(sample_size=256, spread_trigger=1.3, seed=5)
    tp, jp = rebalance.RebalancePlanner(rebalance.RebalanceConfig(**cfg), 4), jreb.RebalancePlanner(
        jreb.RebalanceConfig(**cfg), 4)
    cur = np.sort(rng.integers(0, 2**63, 3, dtype=np.uint64))
    for step in range(12):
        ks = rng.integers(0, 2**63 >> (step % 3), int(rng.integers(1, 400)), dtype=np.uint64)
        tp.observe(ks)
        jp.observe(ks)
        dest = rng.integers(0, 4, 50)
        tp.note_load(dest)
        jp.note_load(dest)
        occ = rng.integers(0, 1000, 4)
        assert tp.should_rebalance(occ) == jp.should_rebalance(occ)
        assert tp.should_compact(step) == jp.should_compact(step)
        np.testing.assert_array_equal(tp.sample.snapshot(), jp.sample.snapshot())
        np.testing.assert_array_equal(tp.propose(cur), jp.propose(cur))
        assert tp.stats() == jp.stats()


def test_straggler_watchdog_equals_the_reference():
    rng = np.random.default_rng(2)
    cfg = dict(ewma=0.3, threshold=1.35, patience=3)
    t = straggler.Watchdog(straggler.StragglerConfig(**cfg))
    j = jstraggler.Watchdog(jstraggler.StragglerConfig(**cfg))
    for step in range(40):
        for host in range(5):
            sec = float(rng.uniform(0.9, 1.1)) * (2.0 if host == 3 and step > 10 else 1.0)
            t.observe(host, sec)
            j.observe(host, sec)
        assert t.end_step() == j.end_step()
        assert t.median() == j.median()
        assert t.plan(5) == j.plan(5)
    assert t.plan(5)["action"] == "remesh" and t.plan(5)["drop_hosts"] == [3]


def test_replica_remesh_and_mesh_plans_equal_the_reference():
    rng = np.random.default_rng(3)
    for _ in range(30):
        g, r = int(rng.integers(1, 6)), int(rng.integers(1, 4))
        alive = rng.random((g, r)) < 0.7
        alive[np.arange(g), rng.integers(0, r, g)] = True  # one survivor a group
        prim = rng.integers(0, r, g).tolist()
        assert_same(elastic.plan_replica_remesh(g, r, alive.tolist(), prim),
                    jelastic.plan_replica_remesh(g, r, alive.tolist(), prim), ("remesh",))
    with pytest.raises(ValueError):
        elastic.plan_replica_remesh(2, 2, [[True, True], [False, False]])
    arch = dict(name="t", family="dense", n_layers=2, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
                vocab_size=32000)
    for n_dev, gb, pref in ((8, 32, None), (16, 64, 4), (64, 64, 8), (12, 24, None)):
        a = elastic.plan_remesh(ArchConfig(**arch), n_dev, gb, prefer_model=pref)
        b = jelastic.plan_remesh(JaxArchConfig(**arch), n_dev, gb, prefer_model=pref)
        assert (a.shape, a.axes, a.n_devices) == (b.shape, b.axes, b.n_devices)
        assert elastic.restart_report(4, n_dev, a) == jelastic.restart_report(4, n_dev, b)
    with pytest.raises(ValueError):
        elastic.plan_remesh(ArchConfig(**arch), 3, 7)


# ---------------------------------------------------------------------------
# twin facades
# ---------------------------------------------------------------------------


def _storm(kind, loaded, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "sequential":
        return loaded.max() + np.uint64(1) + np.arange(n, dtype=np.uint64) * np.uint64(3)
    pool = np.setdiff1d(np.sort(rng.integers(0, 2**63, 4 * n, dtype=np.uint64)), loaded)
    idx = np.unique(zipf_indices(pool.size, 4 * n, alpha=0.99, seed=seed))
    return pool[idx[:n]]


@pytest.mark.parametrize("kind", ["zipf", "sequential"])
def test_skew_storm_with_rebalancing_equals_the_reference(kind):
    keys = sparse(1600, seed=31)
    tw = Twin(keys, keys ^ np.uint64(0xBA5E), 4, rebalance_cfg=rebalance.RebalanceConfig(
        spread_trigger=1.3, sample_size=2048, seed=7))
    rng = np.random.default_rng(5)
    live = set(keys.tolist())
    for w, chunk in enumerate(np.array_split(_storm(kind, keys, 600, seed=41), 5)):
        tw("put", chunk, chunk ^ np.uint64(0xBA5E))
        live.update(chunk.tolist())
        if w % 2:
            dels = rng.choice(np.array(sorted(live), np.uint64), 16)
            tw("delete", dels)
            live.difference_update(dels.tolist())
        tw("occupancy_spread", flush=True)
        tw("maybe_rebalance")
        tw.reads(np.concatenate([rng.choice(np.array(sorted(live), np.uint64), 12), rng.choice(chunk, 4)]))
    assert tw.t.rebalances > 0 and tw.t.migrated_keys > 0
    tw.check((kind,))
    np.testing.assert_array_equal(tw.t.items()[0], np.array(sorted(live), np.uint64))


def test_forced_mid_migration_interleavings_equal_the_reference():
    keys = sparse(1600, seed=31)
    tw = Twin(keys, keys ^ np.uint64(0xC0DE), 4)
    storm = _storm("sequential", keys, 400, seed=3)
    tw("put", storm, storm ^ np.uint64(0xC0DE))
    b0, e0 = tw.t.boundaries.copy(), tw.t.boundary_epoch
    nb = tw.t.planner.propose(b0)
    assert tw("begin_rebalance", nb) and tw.t.in_handoff
    rng = np.random.default_rng(9)
    q = np.concatenate([rng.choice(keys, 16), b0, nb, np.array([0, storm.max()], np.uint64)])
    tw.reads(q, epoch=e0)  # old-epoch waves: routed by the old vector
    tw.reads(q)
    tw.reads(q, limit=40, max_leaves=1)
    wk = np.setdiff1d(q + np.uint64(1), keys)[:10]
    tw("put", wk, wk)  # writes mid-handoff route to the new owners
    tw("delete", q[:5])
    tw("flush")
    tw.reads(q, epoch=e0)
    assert_same(tw.t.items(), tw.j.items(), ("mid items",))
    tw("commit_rebalance")
    with pytest.raises(KeyError):
        tw.t.route_np(q, epoch=e0)
    tw.reads(q)
    tw.check()


def test_compact_chain_across_rebalance_cycles_equals_the_reference():
    """Oscillating storms: every commit extracts slices (leaving empty
    stubs) and compacts them; the stub count stays bounded and equal."""
    keys = sparse(1200, seed=33)
    tw = Twin(keys, keys, 3)
    top = keys.max()
    counts = []
    for cycle in range(3):
        storm = top + np.uint64(1) + np.arange(300, dtype=np.uint64) * np.uint64(7)
        tw("put", storm, storm)
        tw("rebalance")
        tw("delete", storm)  # the storm goes away again: the next refit moves back
        tw("rebalance")
        counts.append(tw("stub_count"))
        tw("maybe_compact")
        tw("compact_chain")
    assert max(counts) < 64
    tw.check()


def test_failover_retire_and_recovery_equal_the_reference():
    keys = sparse(1200, seed=34)
    tw = Twin(keys, keys ^ np.uint64(3), 3, replication=2)
    rng = np.random.default_rng(4)
    q = rng.choice(keys, 24)
    tw("put", q[:4], q[:4], ttl=2)
    assert tw("kill_replica", 0) == 1  # the primary: follower 1 promoted
    e_old = tw.t.boundary_epoch - 1
    tw.reads(q, epoch=e_old)  # old-epoch waves drain under the old primary map
    fresh = np.unique(rng.integers(1, 2**63, 32, dtype=np.uint64))
    tw("put", fresh, fresh)
    tw("retire_failover")
    assert tw("kill_replica", 2, 1) is None  # a follower: no epoch flip
    tw("delete", fresh[:8])
    with pytest.raises(RuntimeError):
        tw("kill_replica", 2, 0)  # the group's last in-sync replica
    tw("recover_replicas")
    tw.reads(q)
    for st in (tw.t, tw.j):
        st.ttl.tick(2)
    tw.reads(q)  # deadlines survive the recovery: the rebuilt replicas share the tracker
    assert not tw("get", q[:4])[1].any() and all(st.ttl is tw.t.ttl for g in tw.t.groups for st in g if st)
    for g in tw.t.groups:  # every replica of a group holds the same items
        assert_same(g[0].items(), g[1].items(), ("replicas",))
    tw.check()
    assert tw.t.failovers == 1 and tw.t.recoveries == 2


@pytest.mark.parametrize("n_from, n_to", [(2, 4), (4, 3)])
def test_reshard_equals_the_reference(n_from, n_to):
    keys = sparse(1200, seed=36)
    tw = Twin(keys, keys ^ np.uint64(5), n_from)
    rng = np.random.default_rng(n_to)
    q = np.concatenate([rng.choice(keys, 20), rng.integers(0, 2**63, 4, dtype=np.uint64)])
    tw("put", q[:8], q[:8])
    tw("put", q[16:20], q[16:20], ttl=1)  # deadlines live in the shared tracker
    tw("begin_reshard", n_to)
    assert tw.t.in_reshard and tw.t.n_shards == n_to
    tw.reads(q, epoch=tw.t.boundary_epoch - 1)  # the retired generation serves old-epoch waves
    tw("put", q[8:16], q[8:16] ^ np.uint64(1))
    tw.reads(q)
    tw("commit_reshard")
    tw.reads(q, limit=40, max_leaves=1)
    for st in (tw.t, tw.j):
        st.ttl.tick(1)
    tw.reads(q)  # the deadlines survived the reshard: those keys read as absent
    assert not tw("get", q[16:20])[1].any()
    tw.check((n_from, n_to))


def test_reshard_through_the_pipeline_is_a_barrier():
    """Waves in flight on ``PipelinedStore`` over the port's facade drain
    before the reshard; the answers equal the reference run serially."""
    keys = sparse(1200, seed=36)
    tw = Twin(keys, keys ^ np.uint64(5), 2)
    pipe = PipelinedStore(tw.t, queue_depth=2)
    rng = np.random.default_rng(7)
    q = rng.choice(keys, 24)
    tickets = [pipe.submit_get(q), pipe.submit_range(q[:8], 10)]
    want = [tw.j.get(q), tw.j.range(q[:8], 10)]  # the reference runs the same waves serially
    assert pipe.pipeline.inflight == 2
    rep = pipe.reshard(4)
    assert pipe.pipeline.inflight == 0
    assert_same(rep, tw.j.reshard(4), ("reshard",))
    for t, w in zip(tickets, want):
        assert_same(pipe.result(t), w, ("in flight",))
    assert_same(pipe.get(q), tw.j.get(q), ("after",))
    tw.check()


def test_watchdog_evacuation_through_the_hook_equals_the_reference():
    """A shard made persistently slow through ``wave_time_hook`` is
    evacuated once by ``maybe_evacuate``, the same on both facades."""
    keys = sparse(1000, seed=55)
    tw = Twin(keys, keys ^ np.uint64(0xBEEF), 4, watchdog=None)
    for s in (tw.t, tw.j):
        s.watchdog = (straggler if s is tw.t else jstraggler).Watchdog(
            (straggler if s is tw.t else jstraggler).StragglerConfig(patience=2))
        s.wave_time_hook = lambda sh, sec, s=s: 0.050 if (sh == 2 and s.evacuations == 0) else 0.001
    q = keys[::20]
    reports = []
    for _ in range(8):
        tw("get", q)
        rep = tw("maybe_evacuate")
        if rep is not None:
            reports.append(rep)
    assert tw.t.evacuations == 1 and reports[0]["evacuated"] == [2] and reports[0]["moved_keys"] > 0
    assert not tw.t.watchdog.flagged
    assert tw.t.watchdog.times == tw.j.watchdog.times
    tw.check()
