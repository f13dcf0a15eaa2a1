"""The port's sharded tiers (``repro_torch.distributed.kvshard`` and
``rangeshard``) against the JAX package, bitwise, on the CPU.

The same numpy-seeded inputs drive the JAX ``ShardedDPAStore`` and the
port's (``device="cpu"``: the kernels' plain versions).  Every output is an
integer, a bool or a count, so every comparison is exact:

* the hash, range and replicated range facades on one op stream (GET, PUT,
  DELETE, RANGE with ``k_max``/``fanout``/``max_leaves=1``, the issue and
  finalize halves, the write fast path, rebalance handoffs with reads under
  both epochs, failover, reshard, chain compaction, TTL and ``as_of``),
  with the scatter-gather and replication counters and ``stats_totals()``;
* empty shards;
* ``_bucketize`` alone, with the ``n_shards`` drop sentinel and overflow;
* ``serve_wave_emulated`` and ``range_wave_emulated`` over ``stacked()``,
  with and without overflow, mixed-epoch tags, ``fanout < n_shards``,
  ``max_rounds=1`` and dead lanes;
* routing of keys and boundaries at and above 2^63, and a mutation check
  that a signed ``%`` in ``shard_of`` would route differently.

Sizes stay at a few thousand keys with one ``TreeConfig`` so the JAX
package compiles few shapes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import TreeConfig as JaxTreeConfig
from repro.core.datasets import sparse
from repro.distributed import kvshard as jkv
from repro.distributed import rangeshard as jrs
from repro_torch.core import TreeConfig, carry
from repro_torch.core.keys import limbs_to_tensor, split_u64, to_i32, u32
from repro_torch.distributed import kvshard, rangeshard

pytestmark = pytest.mark.timeout(300)

GROWTH = 16.0


def build_pair(keys, vals, n_shards, partition, replication=1, **kw):
    """(port facade on the CPU, JAX facade) over the same keys."""
    t = kvshard.ShardedDPAStore(keys, vals, n_shards, TreeConfig(growth=GROWTH), partition=partition,
                                replication=replication, device="cpu", **kw)
    j = jkv.ShardedDPAStore(keys, vals, n_shards, JaxTreeConfig(growth=GROWTH), partition=partition,
                            replication=replication, **kw)
    return t, j


def norm(res):
    """Outputs as nested tuples of numpy arrays and plain values."""
    if res is None or isinstance(res, (bool, int, float, str, np.integer, np.floating)):
        return res
    if isinstance(res, np.ndarray):
        return res
    if isinstance(res, dict):
        return {k: norm(v) for k, v in res.items()}
    if hasattr(res, "rebuilds"):  # a ReplicaRemeshPlan
        return tuple((r.group, r.replica, r.source) for r in res.rebuilds)
    if hasattr(res, "k_lo") and hasattr(res, "donor"):  # a SliceMove
        return (res.boundary, res.donor, res.receiver, res.k_lo, res.k_hi)
    if hasattr(res, "counts") and hasattr(res, "keys"):  # a RangeResult
        return tuple(np.asarray(x) for x in (res.keys, res.vals, res.counts))
    return tuple(norm(x) for x in res)


def assert_same(a, b, ctx):
    a, b = norm(a), norm(b)
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), (ctx, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, (*ctx, i))
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), ctx
        for k in a:
            assert_same(a[k], b[k], (*ctx, k))
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(ctx))
    else:
        assert a == b, (ctx, a, b)


COUNTERS = (
    "range_requests", "range_subqueries", "range_reissues", "range_rounds_in_mesh", "client_writes",
    "replica_writes", "acked_writes", "failovers", "recoveries", "rebalances", "rebalances_aborted",
    "migrated_keys", "reshards", "resharded_keys", "evacuations", "n_shards", "boundary_epoch",
)


def assert_same_facade(t, j, ctx=()):
    for c in COUNTERS:
        assert getattr(t, c) == getattr(j, c), (*ctx, c)
    assert t.stats_totals() == j.stats_totals(), ctx
    assert t.write_amplification == j.write_amplification
    np.testing.assert_array_equal(t.shard_drain_ns > 0, j.shard_drain_ns > 0)
    if t.ownership is not None:
        for f in ("current", "primary", "in_sync"):
            np.testing.assert_array_equal(getattr(t.ownership, f), getattr(j.ownership, f))
    assert_same(t.items(), j.items(), (*ctx, "items"))


def old_epoch(store, old):
    own = store.ownership
    if old and own is not None and own.in_handoff:
        return store.boundary_epoch - 1
    return None


def run(store, script):
    """Replay ``script`` on a facade; returns every op's output."""
    out = []
    snaps = []
    for op in script:
        kind = op[0]
        if kind == "get":
            ep = old_epoch(store, op[2])
            out.append(store.get(op[1], epoch=ep))
        elif kind == "get_split":
            out.append(store.get_finalize(store.get_issue(op[1])))
        elif kind == "put":
            out.append(store.put(op[1], op[2], ttl=op[3]))
        elif kind == "delete":
            out.append(store.delete(op[1]))
        elif kind == "write_split":
            w = store.write_issue(op[1], op[2], op[3])
            out.append(None if w is None else store.write_finalize(w))
        elif kind == "range":
            _, starts, limit, ml, fanout, k_max, old = op
            ep = old_epoch(store, old)
            kw = {} if store.partition == "hash" else {"fanout": fanout}
            out.append(store.range(starts, limit, k_max=k_max, max_leaves=ml, epoch=ep, **kw))
        elif kind == "range_split":
            _, starts, limit, ml, k_max = op
            out.append(store.range_finalize(store.range_issue(starts, limit, k_max=k_max, max_leaves=ml)))
        elif kind == "flush":
            out.append(store.flush())
        elif kind == "begin":
            out.append(store.begin_rebalance(store.planner.propose(store.boundaries)))
        elif kind == "commit":
            out.append(store.commit_rebalance() if store.in_handoff else None)
        elif kind == "kill":
            out.append(store.kill_replica(op[1], op[2]))
        elif kind == "retire":
            out.append(store.retire_failover() if store.ownership.in_handoff else None)
        elif kind == "recover":
            out.append(store.recover_replicas())
        elif kind == "reshard":
            out.append(store.reshard(op[1]))
        elif kind == "compact":
            out.append((store.stub_count(), store.compact_chain()))
        elif kind == "tick":
            out.append(store.ttl.tick(op[1]))
        elif kind == "sweep":
            out.append(store.ttl_sweep())
        elif kind == "snap":
            snaps.append(store.snapshot_epoch())
            out.append(snaps[-1])
        elif kind == "get_as_of":
            out.append(store.get(op[1], as_of=snaps[op[2]]))
        elif kind == "range_as_of":
            out.append(store.range(op[1], op[2], max_leaves=op[3], as_of=snaps[op[4]]))
        elif kind == "maybe":
            out.append((store.maybe_rebalance(), store.maybe_compact()))
        else:
            raise AssertionError(op)
    return out


def op_stream(keys, tier, seed, n_shards):
    """A deterministic stream of every facade operation the tier has."""
    rng = np.random.default_rng(seed)
    rangey = tier != "hash"

    def pick(n, fresh=0):
        q = rng.choice(keys, n - fresh)
        return np.concatenate([q, rng.integers(1, 2**63, fresh, dtype=np.uint64)])

    fresh = np.unique(rng.integers(1, 2**63, 48, dtype=np.uint64))
    # few wave shapes (16 keys, 8 starts; RANGE limit 10 at 4 leaves a round
    # but for one limit-40 scan at 1 leaf) keep the reference's compiles few
    script = [
        ("get", pick(16, 4), False),
        ("put", fresh[:16], fresh[:16] ^ np.uint64(0xF), None),
        ("range", pick(8, 2), 10, 4, None, None, False),
        ("range", pick(8), 40, 1, 2, None, False),
        ("range", pick(8), 10, 4, None, pick(8) | np.uint64(2**62), False),
        ("delete", np.unique(pick(16))),
        ("get_split", pick(16, 4)),
        ("write_split", "put", fresh[16:24], fresh[16:24]),
        ("range_split", pick(8), 10, 4, None),
        ("flush",),
        ("put", pick(16), pick(16), 3),  # TTL puts
        ("range", pick(8), 0, 4, None, None, False),
    ]
    if rangey:
        storm = keys.max() + np.uint64(1) + np.arange(300, dtype=np.uint64) * np.uint64(3)
        script += [
            ("put", storm, storm ^ np.uint64(1), None),
            ("flush",),
            ("begin",),
            ("get", pick(16), True),
            ("range", pick(8), 10, 4, None, None, True),
            ("get", pick(16), False),
            ("range", pick(8), 10, 4, None, None, False),
            ("commit",),
            ("compact",),
        ]
    if tier == "range_r2":
        script += [
            ("kill", 0, None),  # the primary: a failover epoch
            ("get", pick(16), True),
            ("put", fresh[24:32], fresh[24:32], None),
            ("range", pick(8), 10, 4, None, None, True),
            ("retire",),
            ("kill", 1, 1),  # a follower
            ("put", fresh[32:40], fresh[32:40], None),
            ("recover",),
            ("get", pick(16), False),
        ]
    script += [
        ("tick", 4),
        ("get", pick(16), False),
        ("range", pick(8), 10, 4, None, None, False),
        ("sweep",),
        ("compact",),
        ("snap",),
        ("put", pick(16), pick(16), None),
        ("get_as_of", pick(16), 0),
        ("range_as_of", pick(8), 10, 4, 0),
        ("maybe",),
    ]
    if rangey:
        script += [("reshard", 5 - n_shards), ("get", pick(16), False), ("range", pick(8), 10, 4, None, None, False)]
    return script


@pytest.mark.parametrize("tier", ["hash", "range", "range_r2"])
def test_facades_equal_the_reference_on_one_op_stream(tier):
    keys = sparse(2000, seed=7)
    vals = keys ^ np.uint64(0xAB)
    n_shards = 3 if tier == "range" else 2
    t, j = build_pair(keys, vals, n_shards, "hash" if tier == "hash" else "range",
                      replication=2 if tier == "range_r2" else 1, retain_epochs=4)
    script = op_stream(keys, tier, seed=len(tier), n_shards=n_shards)
    got, want = run(t, script), run(j, script)
    for i, (a, b) in enumerate(zip(got, want)):
        assert_same(a, b, (tier, i, script[i][0]))
    assert_same_facade(t, j, (tier,))
    assert t.range_subqueries > t.range_requests > 0
    if tier == "range_r2":
        assert t.failovers == 1 and t.recoveries == 2 and t.write_amplification > 1.5
    if tier != "hash":
        assert t.rebalances == 1 and t.migrated_keys > 0 and t.reshards == 1


def test_sharded_store_tolerates_empty_shards():
    """Fewer keys than shards on the range tier, and a hash tier with empty
    shards: the same answers and state as the reference."""
    keys = np.array([5, 9, 2**40, 2**63 + 7], dtype=np.uint64)
    for part, n in (("range", 6), ("hash", 8)):
        t, j = build_pair(keys, keys ^ np.uint64(3), n, part, cache_cfg=None)
        q = np.concatenate([keys, np.array([0, 6, 2**64 - 2], dtype=np.uint64)])
        assert_same(t.get(q), j.get(q), (part, "get"))
        assert_same(t.range(q, 4), j.range(q, 4), (part, "range"))
        new = np.array([1, 2**62, 2**63 + 1], dtype=np.uint64)
        assert_same(t.put(new, new), j.put(new, new), (part, "put"))
        assert_same(t.range(q, 8, max_leaves=1), j.range(q, 8, max_leaves=1), (part, "range after put"))
        assert_same_facade(t, j, (part,))


# ---------------------------------------------------------------------------
# the device waves
# ---------------------------------------------------------------------------


def limbs(qs, device="cpu"):
    l = limbs_to_tensor(split_u64(qs), device)
    return l[..., 0].contiguous(), l[..., 1].contiguous()


def jlimbs(qs):
    l = split_u64(qs)
    return jnp.asarray(l[..., 0]), jnp.asarray(l[..., 1])


def assert_wave_same(got, want, ctx, mask_vals=None):
    """Port wave outputs (int32-held limbs, bools) == the reference's (u32,
    bools).  ``mask_vals``: (index of the found flag, value indices) — a
    not-found GET row carries 0 here and the probed slot's residue there."""
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want), ctx
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == np.int32 and w.dtype == np.uint32:
            g = g.view(np.uint32)
        if mask_vals is not None and i in mask_vals[1]:
            w = np.where(want[mask_vals[0]], w, 0)
        np.testing.assert_array_equal(g, w, err_msg=f"{ctx} output {i}")


def test_bucketize_drops_sentinels_and_overflow_like_the_reference():
    rng = np.random.default_rng(2)
    n_shards, cap, W = 4, 5, 48
    for trial in range(6):
        # destinations with the n_shards sentinel (fan-out past the last
        # shard) and far more requests per bucket than cap
        dest = rng.integers(0, n_shards + 1, W).astype(np.int32)
        if trial % 2:
            dest[: W // 2] = 1  # one bucket overflows by far
        qs = rng.integers(0, 2**64 - 1, W, dtype=np.uint64)
        tag = rng.integers(0, 2, W).astype(np.int32)
        h, l = limbs(qs)
        got = kvshard._bucketize(torch.from_numpy(dest), h, l, n_shards, cap, extra=(torch.from_numpy(tag),))
        jh, jl = jlimbs(qs)
        want = jkv._bucketize(jnp.asarray(dest), jh, jl, n_shards, cap, extra=(jnp.asarray(tag),))
        assert_wave_same(got, want, ("bucketize", trial))
        origin = got[2].numpy()
        landed = origin[origin >= 0]
        assert np.unique(landed).size == landed.size, "in-range slots are unique: no duplicate winner"
        assert (dest[landed] < n_shards).all(), "sentinel requests land in no bucket"
        per = np.bincount(dest[dest < n_shards], minlength=n_shards)
        assert (got[3].numpy().sum(axis=1) == np.minimum(per, cap)).all()


@pytest.fixture(scope="module")
def wave_world():
    """Range facades (port, JAX) over 4000 keys, their stacked pools, and a
    request set with keys past both ends of the key space."""
    keys = sparse(4000, seed=7)
    t, j = build_pair(keys, keys ^ np.uint64(0xAB), 4, "range", cache_cfg=None)
    W = 16
    rng = np.random.default_rng(0)
    qs = np.concatenate([
        rng.choice(keys, 2 * W),
        rng.integers(0, 2**63, 2 * W - 3, dtype=np.uint64),
        np.array([0, keys.max(), keys.max() + np.uint64(1)], dtype=np.uint64),
    ]).reshape(4, W)
    return t, j, t.stacked(), j.stacked(), qs


def test_stacked_pools_equal_the_reference(wave_world):
    t, j, (tree, ib, depth), (jtree, jib, jdepth), _ = wave_world
    assert depth == jdepth
    for name, a, b in (("tree", tree, jtree), ("ib", ib, jib)):
        for f in a._fields:
            x, y = getattr(a, f).numpy(), np.asarray(getattr(b, f))
            if x.dtype == np.int32 and y.dtype == np.uint32:
                x = x.view(np.uint32)
            np.testing.assert_array_equal(x, y, err_msg=f"{name}.{f}")
    assert kvshard.stacked_bytes(tree, ib) == sum(np.asarray(x).nbytes for x in (*jtree, *jib))


def test_pad_stack_covers_bool_and_zero_dim():
    a = [torch.tensor(3, dtype=torch.int32), torch.tensor(-1, dtype=torch.int32)]
    assert kvshard._pad_stack(a).tolist() == [3, -1]
    b = [torch.ones((2, 3), dtype=torch.bool), torch.ones((1, 4), dtype=torch.bool)]
    got = kvshard._pad_stack(b)
    want = jkv._pad_stack([jnp.ones((2, 3), bool), jnp.ones((1, 4), bool)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("route", ["hash", "range"])
@pytest.mark.parametrize("cap", [16, 3])
def test_serve_wave_emulated_equals_the_reference(wave_world, route, cap):
    """Ample capacity and a cap small enough to overflow (``ok`` False rows
    are RETRY); hash routing over the same stacked pools and the range
    routing of the facade's boundaries."""
    t, _, (tree, ib, depth), (jtree, jib, _), qs = wave_world
    kw = dict(cap=cap, depth=depth, eps_inner=4, eps_leaf=8)
    rt = rangeshard.make_route_fn(t.boundaries) if route == "range" else None
    jrt = jrs.make_route_fn(t.boundaries) if route == "range" else None
    got = kvshard.serve_wave_emulated(tree, ib, *limbs(qs), route_fn=rt, **kw)
    want = jkv.serve_wave_emulated(jtree, jib, *jlimbs(qs), route_fn=jrt, **kw)
    assert_wave_same(got, want, (route, cap), mask_vals=(2, (0, 1)))
    ok = got[3].numpy()
    assert ok.all() == (cap == 16) and ok.any()
    fd = got[2].numpy()
    oracle = dict(zip(*[a.tolist() for a in t.items()]))
    v = (got[0].numpy().view(np.uint32).astype(np.uint64) << np.uint64(32)) | got[1].numpy().view(np.uint32)
    for (i, k), f in np.ndenumerate(fd):
        if ok[i, k] and route == "range":
            assert f == (int(qs[i, k]) in oracle)
            assert int(v[i, k]) == (oracle.get(int(qs[i, k]), 0) if f else 0)


def _handoff_world():
    """A range facade pair with a storm and an open rebalance handoff:
    both boundary epochs live, donors still holding migrated slices (the
    keys and pools of ``wave_world``, so the reference compiles less)."""
    keys = sparse(4000, seed=7)
    t, j = build_pair(keys, keys ^ np.uint64(0xE70C), 4, "range", cache_cfg=None)
    snap = (t.boundaries.copy(), t.stacked(), j.stacked())
    storm = keys.max() + np.uint64(1) + np.arange(420, dtype=np.uint64) * np.uint64(5)
    for s in (t, j):
        s.put(storm, storm ^ np.uint64(0xE70C))
        s.flush()
    nb = t.planner.propose(t.boundaries)
    assert_same(t.begin_rebalance(nb), j.begin_rebalance(nb), ("begin",))
    assert t.in_handoff
    return keys, t, j, snap


def test_waves_under_a_mixed_epoch_tag_equal_the_reference():
    """Mid-rebalance: a GET wave and a RANGE wave whose requests carry
    either epoch's tag, over the handoff's stacked pools."""
    keys, t, j, (b_prev, _, _) = _handoff_world()
    tree, ib, depth = t.stacked()
    jtree, jib, _ = j.stacked()
    rng = np.random.default_rng(5)
    qs = np.concatenate([rng.choice(keys, 56), rng.integers(0, 2**63, 8, dtype=np.uint64)]).reshape(4, 16)
    tag = rng.integers(0, 2, qs.shape).astype(np.int32)
    b_cur = t.boundaries
    got = kvshard.serve_wave_emulated(
        tree, ib, *limbs(qs), cap=16, depth=depth, eps_inner=4, eps_leaf=8,
        route_fn=rangeshard.make_route_fn(b_cur), route_fn_prev=rangeshard.make_route_fn(b_prev),
        epoch_tag=torch.from_numpy(tag))
    want = jkv.serve_wave_emulated(
        jtree, jib, *jlimbs(qs), cap=16, depth=depth, eps_inner=4, eps_leaf=8,
        route_fn=jrs.make_route_fn(b_cur), route_fn_prev=jrs.make_route_fn(b_prev), epoch_tag=jnp.asarray(tag))
    assert_wave_same(got, want, ("get", "mixed"), mask_vals=(2, (0, 1)))
    kw = dict(cap=16, depth=depth, eps_inner=4, limit=10, max_leaves=8, boundaries_prev=b_prev)
    got = rangeshard.range_wave_emulated(tree, ib, *limbs(qs), b_cur, epoch_tag=torch.from_numpy(tag), **kw)
    want = jrs.range_wave_emulated(jtree, jib, *jlimbs(qs), b_cur, epoch_tag=jnp.asarray(tag), **kw)
    assert_wave_same(got, want, ("range", "mixed"))
    # and the facade serves the same rows under each request's epoch
    for e, m in ((t.boundary_epoch - 1, tag == 0), (None, tag == 1)):
        res = t.range(qs[m], 10, max_leaves=8, epoch=e)
        w = got[4].numpy()[m]
        np.testing.assert_array_equal(res.counts, w.sum(axis=1))


@pytest.mark.parametrize(
    "cap, fanout, max_rounds, limit, max_leaves",
    [
        (16, None, 0, 160, 1),  # ample: complete rows after several in-mesh rounds
        (2, 2, 0, 10, 8),  # overflow (RETRY rows) and fanout < n_shards
        (16, None, 1, 40, 1),  # max_rounds=1: truncated rows
    ],
)
def test_range_wave_emulated_equals_the_reference(wave_world, cap, fanout, max_rounds, limit, max_leaves):
    """All eight outputs, per-shard ``rounds`` included; dead lanes ride in
    every bucket the requests do not fill."""
    t, _, (tree, ib, depth), (jtree, jib, _), qs = wave_world
    kw = dict(cap=cap, depth=depth, eps_inner=4, limit=limit, max_leaves=max_leaves, fanout=fanout,
              max_rounds=max_rounds)
    got = rangeshard.range_wave_emulated(tree, ib, *limbs(qs), t.boundaries, **kw)
    want = jrs.range_wave_emulated(jtree, jib, *jlimbs(qs), t.boundaries, **kw)
    assert_wave_same(got, want, (cap, fanout, max_rounds))
    ok, trunc = got[5].numpy(), got[6].numpy()
    assert ok.all() == (cap == 16)
    assert trunc.any() == (max_rounds == 1)
    assert (got[7].numpy().max() > 1) == (limit == 160), "per-shard rounds of the continuation loop"
    if cap == 16 and max_rounds == 0 and fanout is None:  # the host facade gives the same rows
        res = t.range(qs.reshape(-1), limit, max_leaves=max_leaves)
        np.testing.assert_array_equal(res.counts, got[4].numpy().reshape(-1, limit).sum(axis=1))


# ---------------------------------------------------------------------------
# routing hazards: unsigned limbs held as int32
# ---------------------------------------------------------------------------

HIGH_KEYS = np.array(
    [0, 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**63 + 1, 2**63 + 2**32, 2**64 - 2**31, 2**64 - 2],
    dtype=np.uint64,
)


def test_routing_at_and_above_2_63_equals_the_reference():
    rng = np.random.default_rng(8)
    qs = np.concatenate([HIGH_KEYS, rng.integers(2**63, 2**64 - 1, 200, dtype=np.uint64),
                         rng.integers(0, 2**63, 100, dtype=np.uint64)])
    h, l = limbs(qs)
    jh, jl = jlimbs(qs)
    for n in (1, 3, 4, 7):
        got = kvshard.shard_of(h, l, n).numpy()
        np.testing.assert_array_equal(got, np.asarray(jkv.shard_of(jh, jl, n)))
        np.testing.assert_array_equal(got, kvshard.shard_of_np(qs, n))
    for b in (np.array([2**63], dtype=np.uint64), np.array([2**62, 2**63, 2**63 + 5, 2**64 - 2], dtype=np.uint64),
              np.zeros(0, dtype=np.uint64)):
        got = rangeshard.route_range(*rangeshard.boundary_limbs(b), h, l).numpy()
        np.testing.assert_array_equal(got, np.asarray(jrs.route_range(*jrs.boundary_limbs(b), jh, jl)))
        np.testing.assert_array_equal(got, np.searchsorted(b, qs, side="right"))
    # a facade whose boundaries sit above 2^63 routes and serves like the reference
    keys = np.unique(np.concatenate([rng.integers(2**63, 2**64 - 1, 900, dtype=np.uint64), HIGH_KEYS[:-1]]))
    t, j = build_pair(keys, keys, 3, "range", cache_cfg=None)
    assert (t.boundaries >= np.uint64(2**63)).all()
    assert_same(t.get(qs), j.get(qs), ("get",))
    assert_same(t.range(qs[:64], 5), j.range(qs[:64], 5), ("range",))


def test_a_signed_modulo_in_shard_of_routes_differently():
    """Mutation check: ``shard_of`` on the int32 bit pattern (a signed
    ``%``) disagrees with the reference on every hash with its top bit set
    whose shard differs, so the test above would catch it."""
    qs = np.random.default_rng(3).integers(0, 2**64 - 1, 400, dtype=np.uint64)
    h, l = limbs(qs)
    from repro_torch.core.keys import limb_hash

    def signed_shard_of(khi, klo, n):
        return (to_i32(limb_hash(u32(khi), u32(klo), kvshard.SALT_SHARD)) % n).to(torch.int32)

    want = np.asarray(jkv.shard_of(*jlimbs(qs), 3))
    assert not np.array_equal(signed_shard_of(h, l, 3).numpy(), want)
    np.testing.assert_array_equal(kvshard.shard_of(h, l, 3).numpy(), want)


def test_serve_wave_body_equals_the_reference_with_an_identity_exchange():
    """``make_serve_wave``'s body on one shard, whose exchange is the
    identity: the body the multi-device exchange will run."""
    keys = sparse(1500, seed=4)
    t, j = build_pair(keys, keys ^ np.uint64(9), 1, "hash", cache_cfg=None)
    (tree, ib, depth), (jtree, jib, _) = t.stacked(), j.stacked()
    tree, ib = kvshard.shard_state(tree, ib, 0)
    import jax

    jtree = jax.tree.map(lambda a: a[0], jtree)
    jib = jax.tree.map(lambda a: a[0], jib)
    qs = np.concatenate([keys[::50], np.array([0, 2**63 + 3], dtype=np.uint64)])
    for cap in (qs.size, 7):
        body = kvshard.make_serve_wave(1, cap, depth=depth, eps_inner=4, eps_leaf=8)
        jbody = jkv.make_serve_wave(1, cap, depth=depth, eps_inner=4, eps_leaf=8)
        got = body(tree, ib, *limbs(qs), lambda x: x)
        want = jbody(jtree, jib, *jlimbs(qs), lambda x: x)
        assert_wave_same(got, want, ("body", cap), mask_vals=(2, (0, 1)))


def test_stacked_state_carries_to_numpy_like_a_store():
    """``shard_state`` views are contiguous slices of the stack (what the
    kernels read in place), equal to each serving store's own pools."""
    keys = sparse(1200, seed=12)
    t = kvshard.ShardedDPAStore(keys, keys, 3, partition="range", cache_cfg=None, device="cpu")
    tree, ib, _ = t.stacked()
    for s, st in enumerate(t.shards):
        stree, sib = kvshard.shard_state(tree, ib, s)
        assert all(x.is_contiguous() for x in (*stree, *sib))
        mine, theirs = carry.tree_to_numpy(stree), carry.tree_to_numpy(st.tree)
        for f, a in theirs.items():
            b = mine[f]
            np.testing.assert_array_equal(b[tuple(slice(0, n) for n in a.shape)], a, err_msg=f)


def test_facade_builds_every_sub_store_on_the_card_unless_asked():
    keys = sparse(600, seed=2)
    t = kvshard.ShardedDPAStore(keys, keys, 2, partition="range", replication=2, device="cpu")
    assert t.device == torch.device("cpu")
    assert all(st.device == t.device and st.tree.hbm_keys.device == t.device for g in t.groups for st in g)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            kvshard.ShardedDPAStore(keys, keys, 2, partition="hash")
