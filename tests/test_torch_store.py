"""Port ``DPAStore`` == JAX ``DPAStore`` over a seeded op stream.

The same PUT / GET / DELETE / RANGE / flush stream, made with numpy from a
seed, drives the port's store on the CPU (its kernels' plain versions) and
the JAX store.  Every response, ``items()``, every ``StoreStats`` counter
and the final device state must be equal bitwise.  Legs: batched and
per-leaf patching, both caches on, and ``max_leaves=1`` so RANGE runs
several continuation rounds.  Modelled on ``tests/test_differential.py``
and ``tests/test_store_oracle.py``."""

import dataclasses

import numpy as np
import pytest

from repro.core import DPAStore as JaxStore
from repro.core import TreeConfig as JaxTreeConfig
from repro_torch.core import DPAStore, TreeConfig, carry
from repro_torch.core.datasets import osmc, sparse


def _eq_range(a, b, what):
    for f in ("keys", "vals", "counts", "truncated", "cursor_leaf", "cursor_key"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{what}:{f}")
    assert a.rounds == int(b.rounds), what
    assert a.stats == b.stats, what
    assert len(a) == len(b), what


def _eq_state(t: DPAStore, j: JaxStore):
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    for port, ref, to_np in (
        (t.tree, j.tree, carry.tree_to_numpy),
        (t.ib, j.ib, carry.ib_to_numpy),
        (t.cache, j.cache, carry.cache_to_numpy),
        (t.scan_cache, j.scan_cache, carry.scan_cache_to_numpy),
    ):
        got = to_np(port)
        for f in ref._fields:
            np.testing.assert_array_equal(got[f], np.asarray(getattr(ref, f)), err_msg=f)


def _run(seed, *, dataset=sparse, n=1000, batched_patch=True, max_leaves=4, steps=14, ib_cap=8):
    # one key set per dataset: the JAX store's compiled shapes (pool sizes)
    # are then shared by every leg, and only the op stream varies
    keys = dataset(n, seed=11)
    vals = keys ^ np.uint64(0xABCD)
    kw = dict(batched_patch=batched_patch)
    t = DPAStore(keys, vals, TreeConfig(ib_cap=ib_cap, growth=20.0), device="cpu", **kw)
    j = JaxStore(keys, vals, JaxTreeConfig(ib_cap=ib_cap, growth=20.0), **kw)
    rng = np.random.default_rng(seed + 100)
    live = list(keys)
    hot = rng.choice(keys, 24)  # repeated GET keys and RANGE starts: cache hits
    ops_ = ["get", "put_new", "get", "put_old", "range", "delete", "range_state", "get", "range", "flush"]
    for step in range(steps):
        op = ops_[step % len(ops_)] if step < len(ops_) else rng.choice(ops_)
        if op == "get":
            q = np.concatenate([hot, rng.choice(live, 40), rng.integers(0, 2**63, 20, dtype=np.uint64)])
            (tv, tf), (jv, jf) = t.get(q), j.get(q)
            np.testing.assert_array_equal(tf, jf, err_msg=f"step {step} found")
            np.testing.assert_array_equal(tv, jv, err_msg=f"step {step} vals")
        elif op == "put_new":
            ks = rng.integers(0, 2**63, 90, dtype=np.uint64)
            vs = rng.integers(0, 2**64, ks.size, dtype=np.uint64)
            np.testing.assert_array_equal(t.put(ks, vs), j.put(ks, vs))
            live.extend(ks.tolist())
        elif op == "put_old":
            ks = np.concatenate([rng.choice(live, 60), hot[:6]]).astype(np.uint64)
            vs = ks ^ np.uint64(int(rng.integers(1, 2**31)))
            np.testing.assert_array_equal(t.put(ks, vs), j.put(ks, vs))
        elif op == "delete":
            ks = rng.choice(live, 40).astype(np.uint64)
            np.testing.assert_array_equal(t.delete(ks), j.delete(ks))
        elif op == "range":
            starts = np.concatenate([hot[:10], rng.choice(live, 10), keys[-2:]]).astype(np.uint64)
            limit = int(rng.choice([5, 12, 40]))
            a = t.range(starts, limit=limit, max_leaves=max_leaves)
            b = j.range(starts, limit=limit, max_leaves=max_leaves)
            _eq_range(a, b, f"step {step} range")
            k_max = starts + np.uint64(2**40)
            a = t.range(starts, limit=limit, k_max=k_max, max_leaves=max_leaves)
            b = j.range(starts, limit=limit, k_max=k_max, max_leaves=max_leaves)
            _eq_range(a, b, f"step {step} range k_max")
        elif op == "range_state":
            starts = np.concatenate([hot[10:16], rng.choice(live, 6)]).astype(np.uint64)
            a = t.range_with_state(starts, limit=30, max_leaves=max_leaves, max_rounds=1)
            b = j.range_with_state(starts, limit=30, max_leaves=max_leaves, max_rounds=1)
            _eq_range(a, b, f"step {step} bounded")
            m = a.truncated
            if m.any():  # resume from the cursors
                a2 = t.range_with_state(starts[m], limit=30, max_leaves=max_leaves, start_leaves=a.cursor_leaf[m])
                b2 = j.range_with_state(starts[m], limit=30, max_leaves=max_leaves, start_leaves=b.cursor_leaf[m])
                _eq_range(a2, b2, f"step {step} resumed")
        else:
            assert t.flush() == j.flush()
        assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats), f"step {step} ({op})"
    tk, tv = t.items()
    jk, jv = j.items()
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tv, jv)
    _eq_state(t, j)
    assert t.memory_report() == j.memory_report()
    t.flush(), j.flush()
    _eq_state(t, j)
    return t


def test_op_stream_batched():
    t = _run(1)
    assert t.stats.flush_cycles == t.stats.stitch_applies
    assert t.stats.cache_hits > 0 and t.stats.scan_hits > 0


def test_op_stream_per_leaf_patch():
    t = _run(3, batched_patch=False, steps=10)
    assert t.stats.stitch_applies >= t.stats.flush_cycles


def test_op_stream_multi_round_range():
    t = _run(4, max_leaves=1, steps=10)
    assert t.stats.range_rounds_in_mesh > 0


def test_op_stream_osmc():
    _run(5, dataset=osmc, steps=6)


def test_bulk_load_via_stitch_matches_to_device():
    keys = sparse(1200, seed=6)
    a = DPAStore(keys, keys, device="cpu", bulk_load_via_stitch=True)
    b = DPAStore(keys, keys, device="cpu")
    ta, tb = carry.tree_to_numpy(a.tree), carry.tree_to_numpy(b.tree)
    for f in ta:
        np.testing.assert_array_equal(ta[f], tb[f], err_msg=f)


def test_retention_and_ttl_calls_match_the_reference():
    """The calls the first slice refused now behave as in the JAX package:
    ``as_of`` on a store without a window raises ``EpochRetiredError``,
    ``put(..., ttl=)`` returns the same statuses, and a store with a
    retention window builds."""
    from repro.core.epoch import EpochRetiredError as JaxEpochRetiredError
    from repro_torch.core import EpochRetiredError

    keys = sparse(300, seed=7)
    t = DPAStore(keys, keys, device="cpu")
    j = JaxStore(keys, keys)
    for call in (lambda s: s.get(keys[:3], as_of=1), lambda s: s.range(keys[:3], as_of=1)):
        with pytest.raises(EpochRetiredError):
            call(t)
        with pytest.raises(JaxEpochRetiredError):
            call(j)
    np.testing.assert_array_equal(t.put(keys[:3], keys[:3], ttl=5), j.put(keys[:3], keys[:3], ttl=5))
    assert t.ttl.deadlines == j.ttl.deadlines
    r = DPAStore(keys, keys, device="cpu", retain_epochs=2)
    assert r.epochs.retain == 2 and r.snapshot_epoch() == 0
