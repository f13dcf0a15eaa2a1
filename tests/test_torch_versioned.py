"""Point-in-time reads, TTL expiry, chain compaction, slice migration and the
write fast path: the port's ``DPAStore`` == the JAX ``DPAStore`` bitwise.

The same numpy-seeded inputs drive the JAX package and the port on the CPU
(``device="cpu"``: the kernels' plain versions).  Every response,
``items()``, every ``StoreStats`` field, the TTL sidecar and the device
state must be equal.  The oracles are the JAX package's own tests
(``tests/test_versioned.py``, ``tests/test_rebalance.py``).  Retention needs
pool headroom: as there, ``TreeConfig(growth=64.0)`` and a generous
``retain_epochs``.  One key set per leg keeps the JAX store's compiled
shapes few."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import DPAStore as JaxStore
from repro.core import TreeConfig as JaxTreeConfig
from repro.core import lookup as jlookup
from repro.core.epoch import EpochRetiredError as JaxEpochRetiredError
from repro_torch.core import DPAStore, EpochRetiredError, TTLTracker, TreeConfig, carry, lookup
from repro_torch.core.datasets import sparse

RETAIN = 40
GROWTH = 64.0
LO_ALL_ONES = np.uint64(0xFFFFFFFF)


def _keys(n=600, seed=5):
    """Sparse keys, every other one moved to a low limb of 0xFFFFFFFF, so
    that many leaves end on such a key (the k_min advance's carry)."""
    k = sparse(n, seed=seed)
    k[::2] |= LO_ALL_ONES
    return np.unique(k[k < np.uint64(2**64 - 2)])


def _pair(keys, vals, *, retain=RETAIN, growth=GROWTH, cache=True, **kw):
    ccfg = {} if cache else {"cache_cfg": None}
    t = DPAStore(keys, vals, TreeConfig(growth=growth), retain_epochs=retain, device="cpu", **ccfg, **kw)
    j = JaxStore(keys, vals, JaxTreeConfig(growth=growth), retain_epochs=retain, **ccfg, **kw)
    return t, j


def _eq_range(a, b, what):
    for f in ("keys", "vals", "counts", "truncated", "cursor_leaf", "cursor_key"):
        np.testing.assert_array_equal(getattr(a, f), np.asarray(getattr(b, f)), err_msg=f"{what}:{f}")
    assert a.rounds == int(b.rounds), what
    assert a.stats == b.stats, what
    assert len(a) == len(b), what


def _eq_get(a, b, what):
    np.testing.assert_array_equal(a[1], np.asarray(b[1]), err_msg=f"{what} found")
    np.testing.assert_array_equal(a[0], np.asarray(b[0]), err_msg=f"{what} vals")


def _eq_state(t, j, what=""):
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats), what
    assert t.ttl.now == j.ttl.now and t.ttl.deadlines == j.ttl.deadlines, what
    assert t._ttl_snaps == j._ttl_snaps, what
    assert t.epochs.cycle == j.epochs.cycle and t.epochs.epoch == j.epochs.epoch, what
    np.testing.assert_array_equal(t.image.ver_birth, j.image.ver_birth)
    np.testing.assert_array_equal(t.image.ver_prev, j.image.ver_prev)
    pairs = [(t.tree, j.tree, carry.tree_to_numpy), (t.ib, j.ib, carry.ib_to_numpy)]
    if j.cache is not None:
        pairs += [(t.cache, j.cache, carry.cache_to_numpy), (t.scan_cache, j.scan_cache, carry.scan_cache_to_numpy)]
    for port, ref, to_np in pairs:
        got = to_np(port)
        for f in ref._fields:
            np.testing.assert_array_equal(got[f], np.asarray(getattr(ref, f)), err_msg=f"{what} {f}")


def _eq_items(t, j, what=""):
    (tk, tv), (jk, jv) = t.items(), j.items()
    np.testing.assert_array_equal(tk, jk, err_msg=what)
    np.testing.assert_array_equal(tv, jv, err_msg=what)


def _both(t, j, fn):
    return fn(t), fn(j)


# --------------------------------------------------------------------------
# lookup level: the versioned GET and RANGE on a churned tree
# --------------------------------------------------------------------------


def _churned():
    """A JAX store with two snapshots and copy-on-write churn after each,
    so that current leaves resolve into wider ancestors."""
    keys = _keys()
    j = JaxStore(keys, keys ^ np.uint64(0xBEEF), JaxTreeConfig(growth=GROWTH), cache_cfg=None, retain_epochs=RETAIN)
    rng = np.random.default_rng(3)
    e0 = j.snapshot_epoch()
    j.put(keys[::3], keys[::3] ^ np.uint64(0x1111))
    new = np.unique(rng.integers(1, 2**63, 120, dtype=np.uint64)) | LO_ALL_ONES
    j.put(new, new ^ np.uint64(0x2222))
    j.delete(keys[1::7])
    e1 = j.snapshot_epoch()
    j.put(keys[::2], keys[::2] ^ np.uint64(0x3333))
    j.delete(new[::5])
    j.flush()
    return j, keys, new, (e0, e1)


@pytest.fixture(scope="module")
def churned():
    return _churned()


def _queries(keys, new, B=64, seed=9):
    rng = np.random.default_rng(seed)
    q = np.concatenate([rng.choice(keys, B - 24), rng.choice(new, 12), rng.integers(0, 2**64 - 1, 12, dtype=np.uint64)])
    q[:4] = keys[:4] - np.uint64(1)  # a key just below each leaf-ending 0xFFFFFFFF run
    return q[:B]


def _carried(j):
    return carry.tree_from_numpy({f: np.asarray(getattr(j.tree, f)) for f in j.tree._fields}, "cpu")


def test_get_batch_versioned_matches(churned):
    j, keys, new, epochs = churned
    tree = _carried(j)
    q = _queries(keys, new)
    limbs = np.stack([(q >> np.uint64(32)).astype(np.uint32), (q & LO_ALL_ONES).astype(np.uint32)], -1)
    kw = dict(depth=j.depth, eps_inner=j.cfg.eps_inner, eps_leaf=j.cfg.eps_leaf)
    khi, klo = (torch.from_numpy(limbs[:, i].view(np.int32).copy()) for i in (0, 1))
    for e in (*epochs, j.epochs.cycle):
        res = np.array(j._resolve_table(e))
        want = jlookup.get_batch_versioned(j.tree, jnp.asarray(res), jnp.asarray(limbs[:, 0]), jnp.asarray(limbs[:, 1]), **kw)
        got = lookup.get_batch_versioned(tree, torch.from_numpy(res), khi, klo, **kw)
        for a, b, f in zip(got, want, ("vhi", "vlo", "found")):
            np.testing.assert_array_equal(a.numpy().view(np.uint32) if f != "found" else a.numpy(), np.asarray(b), err_msg=f"epoch {e} {f}")


@pytest.mark.parametrize("limit, max_leaves, max_rounds", [(40, 1, 0), (40, 1, 1), (9, 2, 0)])
def test_range_batch_loop_versioned_matches(churned, limit, max_leaves, max_rounds):
    j, keys, new, epochs = churned
    tree = _carried(j)
    q = _queries(keys, new, seed=11)
    limbs = np.stack([(q >> np.uint64(32)).astype(np.uint32), (q & LO_ALL_ONES).astype(np.uint32)], -1)
    jh, jl = jnp.asarray(limbs[:, 0]), jnp.asarray(limbs[:, 1])
    khi, klo = (torch.from_numpy(limbs[:, i].view(np.int32).copy()) for i in (0, 1))
    ub = jnp.full(q.shape, 0xFFFFFFFF, dtype=jnp.uint32)
    tub = torch.full(q.shape, -1, dtype=torch.int32)
    jstart = jlookup.traverse(j.tree, jh, jl, depth=j.depth, eps_inner=j.cfg.eps_inner)
    start = lookup.traverse(tree, khi, klo, depth=j.depth, eps_inner=j.cfg.eps_inner)
    np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
    start = torch.where(torch.arange(q.size) % 9 == 5, -1, start)  # dead lanes
    jstart = jnp.asarray(start.numpy())
    kw = dict(limit=limit, max_leaves=max_leaves, max_rounds=max_rounds)
    carried_rounds = 0
    for e in epochs:
        res = np.array(j._resolve_table(e))
        want = jlookup.range_batch_loop_versioned(j.tree, jnp.asarray(res), jstart, jh, jl, ub, ub, **kw)
        got = lookup.range_batch_loop_versioned(tree, torch.from_numpy(res), start, khi, klo, tub, tub, **kw)
        gk, gv, gvalid, gtrunc, gcur, grounds = got
        wk, wv, wvalid, wtrunc, wcur, wrounds = want
        np.testing.assert_array_equal(gk.numpy().view(np.uint32), np.asarray(wk))
        np.testing.assert_array_equal(gv.numpy().view(np.uint32), np.asarray(wv))
        np.testing.assert_array_equal(gvalid.numpy(), np.asarray(wvalid))
        np.testing.assert_array_equal(gtrunc.numpy(), np.asarray(wtrunc))
        for f in ("khi", "klo", "leaf"):
            a = getattr(gcur, f).numpy()
            np.testing.assert_array_equal(a.view(np.uint32) if f != "leaf" else a, np.asarray(getattr(wcur, f)), err_msg=f)
        assert grounds == int(wrounds)
        # rows whose output crosses a key with the low limb 0xFFFFFFFF and
        # goes on: a later round started from the carried k_min
        kk = gk.numpy().view(np.uint32)
        crossed = (kk[:, :-1, 1] == 0xFFFFFFFF) & gvalid.numpy()[:, 1:]
        carried_rounds += int(crossed.sum())
        if max_rounds == 1:
            assert gtrunc.any(), "a bounded round must leave rows truncated"
    assert carried_rounds > 0


def test_range_k_min_advance_carries_into_the_high_limb():
    """One versioned round that ends on a key whose low limb is 0xFFFFFFFF:
    the next round's k_min is (hi + 1, 0), and the final cursor still falls
    back to the original k_min for rows that emitted nothing."""
    seen = []

    def round_fn(start, h, l):
        seen.append((h.clone(), l.clone()))
        B = start.shape[0]
        k = torch.tensor([[[5, -1]]] * B, dtype=torch.int32)  # key (5, 0xFFFFFFFF)
        valid = torch.tensor([[True], [False]])
        trunc = torch.tensor([len(seen) == 1, False])
        cur = lookup.ScanCursor(k[:, 0, 0], k[:, 0, 1], torch.tensor([3, -1], dtype=torch.int32))
        return k, k, valid, trunc, cur

    start = torch.tensor([0, 0], dtype=torch.int32)
    khi = torch.tensor([5, 7], dtype=torch.int32)
    klo = torch.tensor([1, 2], dtype=torch.int32)
    ub = torch.full((2,), -1, dtype=torch.int32)
    out = lookup.continuation_loop(round_fn, start, khi, klo, ub, ub, limit=4, hard_cap=8, advance_kmin=True)
    assert len(seen) == 2 and out[5] == 2
    assert seen[1][0].tolist() == [6, 7] and seen[1][1].tolist() == [0, 2]
    assert out[4].khi.tolist() == [5, 7] and out[4].klo.tolist() == [-1, 2]


def test_take_follows_the_reference_index_rule():
    t = torch.arange(10, 20)
    idx = torch.tensor([-1, -10, -11, 0, 9, 10, 99])
    assert lookup.take(t, idx).tolist() == np.asarray(jnp.arange(10, 20)[jnp.asarray(idx.numpy())]).tolist()


# --------------------------------------------------------------------------
# store level: versioned reads and TTL over one op stream
# --------------------------------------------------------------------------


@pytest.mark.parametrize("batched_patch", [True, False])
def test_versioned_ttl_op_stream(batched_patch):
    keys = _keys(400, seed=21)
    vals = keys ^ np.uint64(0xBEEF)
    t, j = _pair(keys, vals, batched_patch=batched_patch)
    rng = np.random.default_rng(4)
    ttl_keys = np.unique(rng.integers(2**62, 2**63, 40, dtype=np.uint64)) | LO_ALL_ONES
    hot = rng.choice(keys, 24)

    def probe():
        return np.concatenate([hot, rng.choice(keys, 24), ttl_keys[:12], rng.integers(0, 2**63, 4, dtype=np.uint64)])

    def check_reads(what, as_of=None):
        q = probe()
        _eq_get(t.get(q, as_of=as_of), j.get(q, as_of=as_of), f"{what} get")
        starts = np.concatenate([q[:12], ttl_keys[:2] - np.uint64(3)])
        for limit in (7, 30):
            _eq_range(t.range(starts, limit=limit, as_of=as_of), j.range(starts, limit=limit, as_of=as_of),
                      f"{what} range {limit}")
        a = t.range_with_state(starts, limit=30, max_leaves=1, max_rounds=1, as_of=as_of)
        b = j.range_with_state(starts, limit=30, max_leaves=1, max_rounds=1, as_of=as_of)
        _eq_range(a, b, f"{what} bounded")
        m = a.truncated
        if m.any():
            _eq_range(t.range_with_state(starts[m], limit=30, max_leaves=1, start_leaves=a.cursor_leaf[m], as_of=as_of),
                      j.range_with_state(starts[m], limit=30, max_leaves=1, start_leaves=b.cursor_leaf[m], as_of=as_of),
                      f"{what} resumed")
        k_max = starts + np.uint64(2**58)
        _eq_range(t.range(starts, limit=12, k_max=k_max, as_of=as_of),
                  j.range(starts, limit=12, k_max=k_max, as_of=as_of), f"{what} k_max")
        _eq_state(t, j, what)

    np.testing.assert_array_equal(*_both(t, j, lambda s: np.asarray(s.put(ttl_keys, ttl_keys ^ np.uint64(0xDEAD), ttl=3))))
    s0 = _both(t, j, lambda s: s.snapshot_epoch())
    assert s0[0] == s0[1]
    check_reads("live 0")
    over = keys[::3]
    np.testing.assert_array_equal(*_both(t, j, lambda s: np.asarray(s.put(over, over ^ np.uint64(0x1111)))))
    np.testing.assert_array_equal(*_both(t, j, lambda s: np.asarray(s.put(ttl_keys[:10], ttl_keys[:10], ttl=1))))
    np.testing.assert_array_equal(*_both(t, j, lambda s: np.asarray(s.delete(keys[1::7]))))
    for s in (t, j):
        s.ttl.tick(1)
    check_reads("live 1 (ttl filter)")
    check_reads("as_of s0", as_of=s0[0])
    s1 = _both(t, j, lambda s: s.snapshot_epoch())
    assert s1[0] == s1[1]
    np.testing.assert_array_equal(*_both(t, j, lambda s: np.asarray(s.put(keys[::2], keys[::2] ^ np.uint64(0x3333)))))
    for s in (t, j):
        s.ttl.tick(2)
    check_reads("live 2 (all ttl expired)")
    check_reads("as_of s1", as_of=s1[0])
    _eq_items(t, j, "items before sweep")
    assert t.ttl_sweep() == j.ttl_sweep() > 0
    check_reads("after sweep")
    check_reads("as_of s0 after sweep", as_of=s0[0])
    check_reads("as_of s1 after sweep", as_of=s1[0])
    assert t.ttl_sweep() == j.ttl_sweep() == 0
    _eq_items(t, j, "items after sweep")
    if batched_patch:
        assert t.stats.flush_cycles == t.stats.stitch_applies
    else:
        assert t.stats.stitch_applies >= t.stats.flush_cycles


def test_epoch_retired_where_the_reference_raises():
    keys = _keys(200, seed=9)
    t, j = _pair(keys, keys, retain=2, cache=False)
    e0 = t.snapshot_epoch()
    assert e0 == j.snapshot_epoch()
    for i in range(4):  # burn the window: each flush is one version epoch
        for s in (t, j):
            s.put(keys[:32], keys[:32] ^ np.uint64(i + 10))
            s.flush()
    for call in (lambda s: s.get(keys[:4], as_of=e0), lambda s: s.range(keys[:1], limit=4, as_of=e0),
                 lambda s: s.get(keys[:4], as_of=s.epochs.cycle + 1)):
        with pytest.raises(EpochRetiredError):
            call(t)
        with pytest.raises(JaxEpochRetiredError):
            call(j)
    t0, j0 = _pair(keys, keys, retain=0, cache=False)
    for st, err in ((t0, EpochRetiredError), (j0, JaxEpochRetiredError)):
        with pytest.raises(err):
            st.snapshot_epoch()
    _eq_state(t, j)


def test_ttl_deadline_cleared_by_overwrite_and_delete():
    keys = _keys(180, seed=33)
    t, j = _pair(keys, keys ^ np.uint64(1), cache=False)
    k = keys[:10]
    for s in (t, j):
        s.put(k, k ^ np.uint64(1), ttl=2)
        s.put(k[:5], k[:5] ^ np.uint64(2))  # ttl=None overwrite clears the deadline
        s.delete(k[8:])  # a delete drops it too
        s.ttl.tick(5)
    got = t.get(k)
    _eq_get(got, j.get(k), "ttl get")
    assert got[1].tolist() == [True] * 5 + [False] * 5
    assert t.ttl_sweep() == j.ttl_sweep() == 3
    assert t.ttl_sweep() == j.ttl_sweep() == 0
    _eq_items(t, j)
    _eq_state(t, j)


def test_ttl_tracker_copy_matches_the_reference():
    from repro.core.ttl import TTLTracker as JaxTTL

    a, b = TTLTracker(), JaxTTL()
    keys = np.arange(1, 40, dtype=np.uint64) * np.uint64(2**33 + 7)
    for s in (a, b):
        s.note_put(keys[:20], 3)
        s.tick(2)
        s.note_put(keys[10:30], 1)
        s.note_put(keys[:5], None)
        s.note_delete(keys[25:28])
        s.tick()
    assert a.deadlines == b.deadlines and a.now == b.now and bool(a) == bool(b)
    np.testing.assert_array_equal(a.is_expired_np(keys.reshape(3, 13)), b.is_expired_np(keys.reshape(3, 13)))
    assert sorted(a.expired_keys()) == sorted(b.expired_keys())
    snap = a.freeze()
    a.tick(10)
    np.testing.assert_array_equal(TTLTracker.expired_at(snap, keys), JaxTTL.expired_at(b.freeze(), keys))
    a.prune(keys[:12])
    b.prune(keys[:12])
    assert a.deadlines == b.deadlines


# --------------------------------------------------------------------------
# chain compaction and slice migration
# --------------------------------------------------------------------------


@pytest.mark.parametrize("retain", [0, RETAIN])
def test_extract_compact_ingest(retain):
    keys = sparse(1800, seed=21)
    vals = keys ^ np.uint64(0x51)
    t, j = _pair(keys, vals, retain=retain, growth=8.0 if retain == 0 else GROWTH)
    k_lo, k_hi = keys[500], keys[1300]
    newk = np.setdiff1d(np.arange(1, 40, dtype=np.uint64) * np.uint64(3) + k_lo, keys)
    for s in (t, j):
        s.put(newk, newk ^ np.uint64(0x51))  # buffered writes inside the slice migrate too
    assert t.count_slice(k_lo, k_hi) == j.count_slice(k_lo, k_hi)
    assert t.live_count() == j.live_count() and t.stub_count() == j.stub_count()
    snap = None
    if retain:
        snap = t.snapshot_epoch()
        assert snap == j.snapshot_epoch()
    (tk, tv), (jk, jv) = t.extract_slice(k_lo, k_hi), j.extract_slice(k_lo, k_hi)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tv, jv)
    assert t.count_slice(k_lo, k_hi) == j.count_slice(k_lo, k_hi) == 0
    stubs = t.stub_count()
    assert stubs == j.stub_count() and stubs > 1
    assert t.compact_chain() == j.compact_chain()
    assert t.stub_count() == j.stub_count()
    if not retain:
        assert t.stub_count() < stubs and t.stats.stub_leaves_compacted > 0
    _eq_state(t, j, "after compaction")
    q = np.concatenate([keys[::40], tk[:16], [k_lo, k_hi]]).astype(np.uint64)
    _eq_get(t.get(q), j.get(q), "get after compaction")
    _eq_range(t.range(q, limit=12, max_leaves=1), j.range(q, limit=12, max_leaves=1), "range across the gap")
    if snap is not None:  # the snapshot still serves the extracted slice
        _eq_get(t.get(q, as_of=snap), j.get(q, as_of=snap), "as_of get")
        got = t.get(tk[:16], as_of=snap)
        _eq_get(got, j.get(tk[:16], as_of=snap), "as_of get of the extracted keys")
        assert got[1].all()
        _eq_range(t.range(q, limit=12, as_of=snap), j.range(q, limit=12, as_of=snap), "as_of range")
    assert t.ingest_headroom() == j.ingest_headroom()
    dup_k = np.concatenate([tk, tk[:20]])
    dup_v = np.concatenate([tv, tv[:20] ^ np.uint64(0x77)])  # duplicates: the last wins
    assert t.ingest_slice(dup_k, dup_v) == j.ingest_slice(dup_k, dup_v)
    _eq_items(t, j, "after ingest")
    got = dict(zip(*(a.tolist() for a in t.items())))
    assert all(got[int(k)] == int(v) ^ 0x77 for k, v in zip(tk[:20], tv[:20]))
    assert t.live_count() == j.live_count()
    assert t.count_slice(k_lo, k_hi) == j.count_slice(k_lo, k_hi) == tk.size
    (sk, sv), (jsk, jsv) = t.snapshot_slice(k_lo, k_hi), j.snapshot_slice(k_lo, k_hi)
    np.testing.assert_array_equal(sk, jsk)
    np.testing.assert_array_equal(sv, jsv)
    _eq_state(t, j, "after ingest")
    assert t.stats.migrated_out_keys == tk.size and t.stats.migrated_in_keys == dup_k.size


def test_ingest_splice_and_put_path():
    keys = sparse(2400, seed=31)
    vals = keys ^ np.uint64(0x77)
    half = keys.size // 2
    incoming = np.sort(np.concatenate([keys[half::2], keys[1::37]]))  # overlaps the receiver
    inc_vals = incoming ^ np.uint64(0x99)
    census = {}
    for splice in (True, False):
        t, j = _pair(keys[:half], vals[:half], retain=0, growth=8.0)
        staged = np.setdiff1d(keys[:half] + np.uint64(1), np.concatenate([keys, incoming]))[:40]
        for s in (t, j):
            s.put(staged, staged ^ np.uint64(0x55))
        assert t.ingest_slice(incoming, inc_vals, splice=splice) == j.ingest_slice(incoming, inc_vals, splice=splice)
        _eq_items(t, j, f"splice={splice}")
        _eq_state(t, j, f"splice={splice}")
        census[splice] = t.items()
    for a, b in zip(census[True], census[False]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the async write fast path
# --------------------------------------------------------------------------


def test_write_fast_path_matches_serial_and_reference():
    keys = sparse(1000, seed=13)
    vals = keys ^ np.uint64(0xABCD)
    t, j = _pair(keys, vals, retain=0, growth=20.0)
    serial = DPAStore(keys, vals, TreeConfig(growth=20.0), device="cpu")
    rng = np.random.default_rng(6)
    n_none = n_fast = 0
    for step in range(12):
        op = "put" if step % 3 else "delete"
        ks = rng.choice(keys, 24 if step < 10 else 200).astype(np.uint64)
        vs = ks ^ np.uint64(step + 1)
        wt = t.write_issue(op, ks, vs if op == "put" else None)
        wj = j.write_issue(op, ks, vs if op == "put" else None)
        assert (wt is None) == (wj is None), step
        if wt is None:  # a buffer could reach ib_cap: the serial path
            n_none += 1
            st = [getattr(s, op)(ks, vs) if op == "put" else s.delete(ks) for s in (t, j, serial)]
        else:
            n_fast += 1
            st = [t.write_finalize(wt), np.asarray(j.write_finalize(wj)),
                  serial.put(ks, vs) if op == "put" else serial.delete(ks)]
            assert (st[0] == 0).all()
        for x in st[1:]:
            np.testing.assert_array_equal(st[0], x)
        q = rng.choice(keys, 48)
        got = t.get(q)
        _eq_get(got, j.get(q), f"step {step}")
        _eq_get(got, serial.get(q), f"step {step} serial")
        _eq_range(t.range(q[:8], limit=10), j.range(q[:8], limit=10), f"step {step} range")
        _eq_state(t, j, f"step {step}")
    assert n_fast > 0 and n_none > 0
    empty = t.write_issue("put", np.zeros(0, dtype=np.uint64))
    assert t.write_finalize(empty).size == 0
    _eq_items(t, j)
    (tk, tv), (sk, sv) = t.items(), serial.items()
    np.testing.assert_array_equal(tk, sk)
    np.testing.assert_array_equal(tv, sv)
    for f in ("puts", "deletes", "gets", "flush_cycles", "stitch_applies"):
        assert getattr(t.stats, f) == getattr(serial.stats, f), f


def test_store_has_every_public_method_of_the_reference():
    import inspect

    names = [n for n in dir(JaxStore) if not n.startswith("__")]
    public = [n for n in names if not n.startswith("_")]
    helpers = ["_resolve_table", "_note_cycle_end", "_ttl_snap_for", "_range_filtered", "_slice_run",
               "_stub_version_safe", "_write_plan"]
    for n in public + helpers:
        assert hasattr(DPAStore, n), n
        a, b = getattr(DPAStore, n), getattr(JaxStore, n)
        if callable(b):
            assert inspect.signature(a) == inspect.signature(b), n


def test_cpu_pools_do_not_alias_the_host_image():
    """On the CPU the device pools are copies: the patcher's host edits
    (a compacted stub's ``leaf_next`` set to -1) reach them only through
    the stitch, as on the card."""
    keys = sparse(1000, seed=3)
    t = DPAStore(keys, keys, device="cpu")
    before = t.tree.leaf_next.clone()
    t.image.leaf_next[:] = -7
    t.image.leaf_count[:] = -7
    assert torch.equal(t.tree.leaf_next, before)
    assert not bool((t.tree.leaf_count == -7).any())
