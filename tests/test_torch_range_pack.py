"""Kernel B5, the scan wave's pack, and the drain that copies it out.

``pack_plain`` is held bitwise against the numpy epilogue that
``DPAStore.range_finalize`` ran on the host before the pack moved to the
device (copied below as the oracle); the store's RANGE paths, the depth-2
pipeline and the sharded facade are held against that oracle and against
serial runs, with results held across later waves.  The ``cuda`` tests hold
the kernel against ``pack_plain`` and the store on the card against the
CPU.  This file imports no JAX, so its card tests run without it."""

import numpy as np
import pytest
import torch

from repro_torch.core import DPAStore, datasets
from repro_torch.core.keys import KEY_MAX, join_u64, split_u64
from repro_torch.core.tree import TreeConfig
from repro_torch.distributed.kvshard import ShardedDPAStore
from repro_torch.kernels import build, range_pack
from repro_torch.serving.pipeline import PipelinedStore

FIELDS = ("keys", "vals", "counts", "truncated", "cursor_leaf", "cursor_key")


def numpy_epilogue(va, rk, rv, trunc, cur_leaf, cur_limbs, start_keys_u64, limit):
    """``range_finalize``'s host epilogue as it stood before the pack: the
    accumulators allocated at issue, then the copy-out and epilogue."""
    n = start_keys_u64.size
    lim = max(limit, 0)
    keys_out = np.zeros((n, lim), dtype=np.uint64)
    vals_out = np.zeros((n, lim), dtype=np.uint64)
    counts = np.zeros(n, dtype=np.int64)
    trunc_out = np.zeros(n, dtype=bool)
    cur_leaf_out = np.full(n, -1, dtype=np.int32)
    cur_key_out = start_keys_u64.copy()
    rc = va.sum(axis=1)
    keys_out[:] = np.where(va, join_u64(rk), 0)
    vals_out[:] = np.where(va, join_u64(rv), 0)
    counts[:] = rc
    trunc_out[:] = trunc
    cur_leaf_out[:] = cur_leaf
    last_key = join_u64(cur_limbs)
    emitted = rc > 0
    cur_key_out[emitted] = last_key[emitted]
    trunc_out &= counts < limit
    return keys_out, vals_out, counts, trunc_out, cur_leaf_out, cur_key_out


def _limbs_i32(u64: np.ndarray) -> np.ndarray:
    return split_u64(u64).view(np.int32)


def make_wave(n, limit, seed, *, counts=None, near_max=False, scattered=False):
    """Inputs of a pack as the range loop leaves them: random limbs over the
    whole u64 range (the high bit set in either half), junk past each row's
    count, a prefix mask (or a scattered one), random flags and cursors."""
    rng = np.random.default_rng(seed)

    def u64(shape):
        x = rng.integers(0, 2**64, size=shape, dtype=np.uint64)
        if near_max:
            x = KEY_MAX - rng.integers(1, 4, size=shape, dtype=np.uint64)
        return x

    if counts is None:
        counts = rng.integers(0, limit + 1, size=n)
        counts[rng.random(n) < 0.25] = 0
        counts[rng.random(n) < 0.25] = limit
    valid = np.arange(limit)[None, :] < np.asarray(counts)[:, None]
    if scattered:
        valid = rng.random((n, limit)) < 0.5
    start = u64(n)
    return dict(
        rk=_limbs_i32(u64((n, limit))),
        rv=_limbs_i32(u64((n, limit))),
        valid=valid,
        trunc=rng.random(n) < 0.5,
        cur_leaf=rng.integers(-1, 2**31 - 1, size=n).astype(np.int32),
        cur_limbs=_limbs_i32(u64(n)),
        start=start,
        limit=limit,
    )


def pack_args(w, device="cpu"):
    t = {k: torch.from_numpy(np.ascontiguousarray(w[k])).to(device) for k in ("rk", "rv", "valid", "trunc", "cur_leaf")}
    cur = torch.from_numpy(np.ascontiguousarray(w["cur_limbs"])).to(device)
    st = torch.from_numpy(_limbs_i32(w["start"])).to(device)
    return (t["rk"], t["rv"], t["valid"], t["trunc"], t["cur_leaf"], cur[:, 0].contiguous(), cur[:, 1].contiguous(),
            st[:, 0].contiguous(), st[:, 1].contiguous())


def unpacked(buf, n, limit):
    return range_pack.unpack(buf.cpu(), n, limit)


def assert_fields_equal(got, want, what):
    for name, a, b in zip(FIELDS, got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), (what, name)


def _truncated_at_the_limit(n, limit, seed):
    w = make_wave(n, limit, seed, counts=np.array([limit, limit - 1, 0, limit][:n]))
    w["trunc"][:] = True  # count == limit: cleared; count < limit: kept
    return w


CASES = {
    "mixed_rows": lambda: make_wave(64, 100, 1),
    "empty_rows": lambda: make_wave(9, 12, 2, counts=np.zeros(9, dtype=np.int64)),
    "full_rows": lambda: make_wave(9, 12, 3, counts=np.full(9, 12)),
    "keys_next_to_key_max": lambda: make_wave(17, 8, 4, near_max=True),
    "truncated_at_and_below_the_limit": lambda: _truncated_at_the_limit(4, 6, 5),
    "n_1": lambda: make_wave(1, 100, 6),
    "limit_1": lambda: make_wave(33, 1, 7),
    "n_1_limit_1": lambda: make_wave(1, 1, 8, counts=np.array([1])),
    "odd_slot_count": lambda: make_wave(3, 7, 9),
    "scattered_mask": lambda: make_wave(40, 13, 10, scattered=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_plain_equals_the_numpy_epilogue(case):
    w = CASES[case]()
    n, limit = w["start"].size, w["limit"]
    want = numpy_epilogue(w["valid"], w["rk"], w["rv"], w["trunc"], w["cur_leaf"], w["cur_limbs"], w["start"], limit)
    buf = range_pack.pack(*pack_args(w), limit=limit)
    assert buf.dtype == torch.uint8 and buf.numel() == range_pack.layout(n, limit).nbytes
    got = unpacked(buf, n, limit)
    assert_fields_equal(got, want, case)
    for a in got:
        assert a.flags.writeable and a.flags.owndata


def test_layout_aligns_every_field():
    for n, limit in ((1, 1), (3, 7), (62259, 100), (5, 2)):
        lay = range_pack.layout(n, limit)
        assert all(off % 16 == 0 for off in lay)
        assert lay.vals >= 8 * n * limit and lay.truncated + n <= lay.nbytes


# --------------------------------------------------------------- the store


@pytest.fixture(scope="module")
def keys():
    return datasets.sparse(6000, seed=27)


def _store(keys, device="cpu", **kw):
    return DPAStore(keys, keys ^ np.uint64(0x77), TreeConfig(growth=16.0), device=device, **kw)


def _capture(store):
    """Record the range loop's outputs of each wave the store stages."""
    seen = []
    stage = store._stage_range

    def spy(w, out, khi, klo):
        seen.append((w.limit, [t.clone() for t in out[:4]], out[4], khi.clone(), klo.clone()))
        return stage(w, out, khi, klo)

    store._stage_range = spy
    return seen


def _epilogue_of(rec, start):
    limit, (rk, rv, valid, trunc), cursor, _, _ = rec
    limbs = torch.stack([cursor.khi, cursor.klo], dim=-1)
    return numpy_epilogue(valid.numpy(), rk.numpy(), rv.numpy(), trunc.numpy(), cursor.leaf.numpy(),
                          limbs.numpy(), start, limit)


def _fields(r):
    return tuple(np.asarray(getattr(r, f)) for f in FIELDS)


def test_store_range_equals_the_numpy_epilogue_on_the_cpu(keys):
    st = _store(keys)
    seen = _capture(st)
    rng = np.random.default_rng(3)
    starts = np.concatenate([rng.choice(keys, 200), rng.integers(0, 2**64 - 1, 40, dtype=np.uint64),
                             np.array([KEY_MAX - np.uint64(1)], dtype=np.uint64)])
    calls = [
        dict(limit=10),
        dict(limit=100, max_leaves=1),
        dict(limit=64, max_leaves=1, max_rounds=1),
        dict(limit=1),
        dict(limit=40, k_max=starts + np.uint64(2**52)),
    ]
    outs = []
    for kw in calls:
        outs.append(st.range_with_state(starts, **kw))
        assert_fields_equal(_fields(outs[-1]), _epilogue_of(seen[-1], starts), kw)
    assert len(seen) == len(calls)
    assert outs[2].truncated.any() and not outs[0].truncated.any()
    assert (outs[0].counts == 0).any() and (outs[0].counts == 10).any()  # empty and full rows
    spans = st.span_totals()
    assert spans["kv/range/pack"][1] == len(calls) == spans["kv/range/copy"][1]


def test_held_results_stay_unchanged_and_writable(keys):
    """A result of wave k, held while waves k+1..k+3 are issued and
    drained, keeps its values; it is writable, and writing it changes no
    later result."""
    st = _store(keys)
    rng = np.random.default_rng(5)
    waves = [rng.choice(keys, 300) for _ in range(4)]
    held = st.range(waves[0], limit=50)
    snap = [a.copy() for a in _fields(held)]
    later = [st.range(q, limit=50) for q in waves[1:]]
    assert_fields_equal(_fields(held), snap, "held")
    for a in _fields(held):
        assert a.flags.writeable
    held.counts[:] = 0
    held.vals[:] = 1
    again = _store(keys)
    for q, r in zip(waves[1:], later):
        assert_fields_equal(_fields(r), _fields(again.range(q, limit=50)), "later")
    assert st.span_totals()["kv/range/pack"][1] == 4


def test_waves_in_flight_never_share_a_staging_buffer(keys):
    st, serial = _store(keys), _store(keys)
    rng = np.random.default_rng(6)
    qs = [rng.choice(keys, n) for n in (50, 400, 20, 400)]
    waves = [st.range_issue(q, limit=30, arity=6) for q in qs]
    ptrs = [w.staged[0].data_ptr() for w in waves]
    assert len(set(ptrs)) == len(ptrs)
    outs = [st.range_finalize(w) for w in reversed(waves)][::-1]
    for q, r in zip(qs, outs):
        assert_fields_equal(_fields(r), _fields(serial.range_with_state(q, limit=30)), "out of order")
    assert len(st._staging._free) == 4
    big = max(b[0].numel() for b in st._staging._free)
    st.range_finalize(st.range_issue(qs[1], limit=30))  # reuses a buffer: no new one
    assert len(st._staging._free) == 4 and max(b[0].numel() for b in st._staging._free) == big
    with pytest.raises(RuntimeError, match="already drained"):
        st.range_finalize(waves[0])


def test_degenerate_and_filtered_waves_take_no_pack(keys):
    st = _store(keys)
    r = st.range(keys[:5], limit=0)
    assert r.keys.shape == (5, 0) and np.array_equal(r.cursor_key, keys[:5])
    assert st.range(keys[:0], limit=10).keys.shape == (0, 10)
    assert "kv/range/pack" not in st.span_totals()
    st.put(keys[:50], keys[:50], ttl=1)
    st.ttl.tick(2)
    r = st.range(keys[:20], limit=10)  # the TTL refill loop: one pack a wave inside it
    live = [r.keys[i, : r.counts[i]] for i in range(20)]
    assert not np.isin(np.concatenate(live), keys[:50]).any() and (r.counts == 10).all()
    assert st.span_totals()["kv/range/pack"][1] >= 1


@pytest.mark.parametrize("qd", [1, 2])
def test_pipelined_scans_equal_serial_ones(keys, qd):
    st, serial = _store(keys), _store(keys)
    pipe = PipelinedStore(st, queue_depth=qd)
    rng = np.random.default_rng(7)
    qs = [rng.choice(keys, 256) for _ in range(6)]
    tickets = [pipe.submit_range(q, 100, max_leaves=4) for q in qs]
    first = pipe.result(tickets[0])
    snap = [a.copy() for a in _fields(first)]
    outs = [pipe.result(t) for t in tickets[1:]]
    assert_fields_equal(_fields(first), snap, "held across the pipeline")
    for q, r in zip(qs, [first, *outs]):
        want = serial.range(q, limit=100, max_leaves=4)
        for f in ("keys", "vals", "counts"):
            assert np.array_equal(getattr(r, f), getattr(want, f)), f
    assert pipe.span_totals()["kv/range/pack"][1] == len(qs)


@pytest.mark.parametrize("partition", ["hash", "range"])
def test_sharded_sub_waves_in_flight_equal_serial_ones(keys, partition):
    kw = dict(partition=partition, device="cpu")
    a = ShardedDPAStore(keys, keys ^ np.uint64(3), 3, TreeConfig(growth=16.0), **kw)
    b = ShardedDPAStore(keys, keys ^ np.uint64(3), 3, TreeConfig(growth=16.0), **kw)
    rng = np.random.default_rng(8)
    qs = [rng.choice(keys, 200) for _ in range(3)]
    waves = [a.range_issue(q, 40) for q in qs]
    outs = [a.range_finalize(w) for w in waves]
    for q, r in zip(qs, outs):
        want = b.range(q, 40)
        for f in ("keys", "vals", "counts"):
            assert np.array_equal(getattr(r, f), getattr(want, f)), (partition, f)
    packs = sum(s.span_totals().get("kv/range/pack", (0, 0))[1] for s in a._live_stores())
    assert packs >= len(qs)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,limit", [(62259, 100), (1, 1), (3, 7), (33, 1), (1, 100), (1000, 63), (4099, 5)])
def test_pack_kernel_equals_plain_version_on_the_card(cuda_device, n, limit):
    for seed, extra in ((11, {}), (12, dict(near_max=True)), (13, dict(scattered=True))):
        w = make_wave(n, limit, seed, **extra)
        args = pack_args(w, cuda_device)
        before = build.launches["range_pack"]
        got = range_pack.pack_cuda(*args, limit=limit)
        torch.cuda.synchronize()
        assert build.launches["range_pack"] == before + 1
        want = range_pack.pack_plain(*args, limit=limit)
        assert_fields_equal(unpacked(got, n, limit), unpacked(want, n, limit), (n, limit, seed))


@pytest.mark.cuda
def test_pack_kernel_refuses_what_it_does_not_take(cuda_device):
    args = list(pack_args(make_wave(4, 6, 1), cuda_device))
    with pytest.raises(ValueError):
        range_pack.pack_cuda(*args, limit=5)
    args[0] = args[0].to(torch.int64)
    with pytest.raises(TypeError):
        range_pack.pack_cuda(*args, limit=6)


@pytest.mark.cuda
def test_store_scans_on_the_card_equal_the_cpu_and_stay_held(cuda_device, keys):
    card, cpu = _store(keys, cuda_device), _store(keys)
    rng = np.random.default_rng(9)
    qs = [np.concatenate([rng.choice(keys, 500), rng.integers(0, 2**64 - 1, 20, dtype=np.uint64)]) for _ in range(4)]
    before = build.launches["range_pack"]
    held = card.range_with_state(qs[0], limit=100, max_leaves=2)
    snap = [a.copy() for a in _fields(held)]
    assert_fields_equal(_fields(held), _fields(cpu.range_with_state(qs[0], limit=100, max_leaves=2)), "wave 0")
    pipe = PipelinedStore(card, queue_depth=2)
    tickets = [pipe.submit_range(q, 100, max_leaves=2) for q in qs[1:]]
    for q, t in zip(qs[1:], tickets):
        r = pipe.result(t)
        want = cpu.range(q, limit=100, max_leaves=2)
        for f in ("keys", "vals", "counts"):
            assert np.array_equal(getattr(r, f), getattr(want, f)), f
    assert_fields_equal(_fields(held), snap, "held on the card")
    assert all(a.flags.writeable for a in _fields(held))
    bounded = [s.range_with_state(qs[1], limit=64, max_leaves=1, max_rounds=1) for s in (card, cpu)]
    assert_fields_equal(_fields(bounded[0]), _fields(bounded[1]), "bounded")
    assert build.launches["range_pack"] == before + len(qs) + 1
