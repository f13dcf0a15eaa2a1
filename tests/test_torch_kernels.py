"""Port kernels == JAX kernels, one comparison per TPU kernel the port
replaces (B1 GET, B2 cache probe at P=2 and P=1, B3 range walk) plus the
multi-round RANGE op.  On the CPU the port's wrappers run their kernels'
plain versions; the JAX side runs its Pallas kernels in interpret mode, as
``tests/test_kernels.py`` does.  Inputs are made with numpy from a seed and
fed to both; the JAX store's device state is carried over with
``repro_torch.core.carry``.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DPAStore as JaxStore
from repro.core import TreeConfig as JaxTreeConfig
from repro.core import hotcache as jhot
from repro.core import lookup as jlookup
from repro.core import scancache as jscan
from repro.core.datasets import dense4x, face, osmc, sparse
from repro.core.keys import split_u64
from repro.kernels import cache_probe as jprobe
from repro.kernels import ops as jops
from repro.kernels.range_scan import range_pallas
from repro_torch.core import cacheset, carry, hotcache, lookup, scancache
from repro_torch.core.hotcache import CacheConfig
from repro_torch.core.keys import u32
from repro_torch.core.scancache import ScanCacheConfig
from repro_torch.kernels import cache_probe, ops, range_scan, traverse


def _mk(n, dataset=sparse, eps=(4, 8), seed=7, churn=0):
    """A churned JAX store (buffered PUT/DEL left in its insert buffers)."""
    keys = dataset(n, seed=seed)
    st = JaxStore(
        keys,
        keys ^ np.uint64(0x5A5A),
        JaxTreeConfig(eps_inner=eps[0], eps_leaf=eps[1], ib_cap=16),
        cache_cfg=None,
    )
    rng = np.random.default_rng(seed + 1)
    if churn:
        newk = np.setdiff1d(rng.integers(0, 2**63, churn, dtype=np.uint64), keys)
        st.put(newk, newk + np.uint64(77))
        st.delete(keys[10 : 10 + churn // 4])
    return st, keys, rng


def _carry(st):
    t = carry.tree_from_numpy({f: np.asarray(getattr(st.tree, f)) for f in st.tree._fields}, "cpu")
    ib = carry.ib_from_numpy({f: np.asarray(getattr(st.ib, f)) for f in st.ib._fields}, "cpu")
    return t, ib


def _limbs(q):
    l = split_u64(q)
    j = (jnp.asarray(l[:, 0]), jnp.asarray(l[:, 1]))
    t = (
        torch.from_numpy(l[:, 0].view(np.int32).copy()),
        torch.from_numpy(l[:, 1].view(np.int32).copy()),
    )
    return j, t


def _eq(port, ref, what=""):
    a = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref)
    if b.dtype == np.uint32:
        b = b.view(np.int32)
    if a.dtype == np.bool_ or b.dtype == np.bool_:
        a, b = a.astype(bool), b.astype(bool)
    np.testing.assert_array_equal(a, b, err_msg=what)


# ---------------------------------------------------------------- B1: GET


@pytest.mark.parametrize(
    "n,dataset,eps,churn",
    [
        (1000, sparse, (4, 8), 0),
        (2500, sparse, (4, 8), 150),
        (3000, dense4x, (4, 8), 60),
        (3000, osmc, (16, 16), 60),
        (2000, face, (16, 16), 0),
        (1000, sparse, (1, 2), 40),
    ],
)
def test_get_plain_matches_pallas(n, dataset, eps, churn):
    st, keys, rng = _mk(n, dataset, eps, churn=churn)
    tree, ib = _carry(st)
    for n_q in (200,):
        q = np.concatenate(
            [rng.choice(keys, n_q // 2), rng.integers(0, 2**63, n_q - n_q // 2, dtype=np.uint64)]
        )
        (jh, jl), (th, tl) = _limbs(q)
        kw = dict(depth=st.depth, eps_inner=eps[0], eps_leaf=eps[1])
        want = jops.get(st.tree, st.ib, jh, jl, impl="pallas_interpret", **kw)
        got = ops.get(tree, ib, th, tl, **kw)
        for g, w, name in zip(got, want, ("vhi", "vlo", "found")):
            _eq(g, w, name)


def test_get_far_queries_hit_the_saturating_cast():
    """osmc at eps 16/16 with random far queries: many leaf predictions
    exceed 2^31, where a wrapping float->int32 cast would pick the wrong
    window.  Pins that the case is exercised and that the port agrees."""
    st, keys, rng = _mk(3000, osmc, (16, 16), seed=3)
    tree, ib = _carry(st)
    q = rng.integers(0, 2**64, 512, dtype=np.uint64)
    (jh, jl), (th, tl) = _limbs(q)
    leaf = lookup.traverse(tree, th, tl, depth=st.depth, eps_inner=16).long()
    anchor = u32(tree.leaf_anchor[leaf])
    pred = lookup._predict(tree.leaf_slope[leaf], anchor[:, 0], anchor[:, 1], u32(th), u32(tl))
    assert int((pred >= 2.0**31).sum()) > 0, "no far prediction: hazard not exercised"
    kw = dict(depth=st.depth, eps_inner=16, eps_leaf=16)
    want = jops.get(st.tree, st.ib, jh, jl, impl="pallas_interpret", **kw)
    got = ops.get(tree, ib, th, tl, **kw)
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(leaf.to(torch.int32), jlookup.traverse(st.tree, jh, jl, depth=st.depth, eps_inner=16))
    root_t = tree.root.expand(q.size)
    root_j = jnp.broadcast_to(st.tree.root, jh.shape)
    _eq(lookup.route_one_level(tree, root_t, th, tl, 16), jlookup.route_one_level(st.tree, root_j, jh, jl, 16))


@pytest.mark.parametrize("B", [1, 200, 8448, 65536, 262144])
@pytest.mark.parametrize("eps", [(4, 8), (16, 16), (1, 2), (70, 8)])
@pytest.mark.parametrize("ctas", [8, 6])
def test_get_launch_plan_is_valid(ctas, eps, B):
    """Kernel B1's launch plan: every request owned by exactly one warp (or
    thread) of one CTA; a warp per request exactly when the whole wave fits
    on the card at once that way and each window with the key before it
    fits the warp's passes (so always for the page table's 1-request wave),
    else a thread per request.  ``ctas``: CTAs of 256 threads an SM holds
    (8 = every thread slot)."""
    sm = 132
    occupancy = lambda warp, threads: ctas * 256 // threads  # noqa: E731
    plan = traverse.get_plan(B, *eps, sm, occupancy)
    fits = 2 * max(eps) + 3 <= 32 * traverse.MAX_PASSES
    per_cta = plan.threads // 32 if plan.warp else plan.threads
    assert plan.threads % 32 == 0 and plan.threads <= traverse.WARP_CTA
    assert plan.grid == -(-B // per_cta)
    t = min(traverse.WARP_CTA, 32 * B)  # the warp kernel's CTA for this wave
    assert plan.warp == (fits and B <= sm * occupancy(True, t) * (t // 32))
    if B == 1:
        assert plan.warp == fits and plan.grid == 1
    owner = np.zeros(plan.grid * per_cta, dtype=np.int64)  # the kernel: i = cta * per_cta + unit
    for cta in range(plan.grid):
        owner[cta * per_cta : (cta + 1) * per_cta] += 1
    assert (owner[:B] == 1).all()


# ------------------------------------------------------- B2: cache probe


def _colliding_wave(rng, n):
    """Keys with in-wave duplicates carrying different values, so several
    requests of one wave aim at the same (thread, bucket, way)."""
    base = rng.integers(0, 2**63, n, dtype=np.uint64)
    ks = np.concatenate([base, base[: n // 3], base[: n // 5]])
    vs = rng.integers(0, 2**64, ks.size, dtype=np.uint64)
    return ks, vs


@pytest.mark.parametrize("n_threads,n_buckets", [(8, 24), (176, 24), (16, 8)])
def test_cache_probe_p2_matches_pallas(n_threads, n_buckets):
    cfg_j = jhot.CacheConfig(n_threads=n_threads, n_buckets=n_buckets, admit_shift=1)
    cfg_t = CacheConfig(n_threads=n_threads, n_buckets=n_buckets, admit_shift=1)
    jc = jhot.make_cache(cfg_j)
    tc = hotcache.make_cache(cfg_t, "cpu")
    rng = np.random.default_rng(3)
    admitted = []
    for w in range(5):
        ks, vs = _colliding_wave(rng, 240)
        admitted.append(ks)
        (jh, jl), (th, tl) = _limbs(ks)
        vl = split_u64(vs)
        el = rng.random(ks.size) < 0.9
        jc = jhot.admit(
            jc, jhot.steer(jh, jl, n_threads), jh, jl,
            jnp.asarray(vl[:, 0]), jnp.asarray(vl[:, 1]), jnp.asarray(el), cfg=cfg_j, wave=w,
        )
        tc = hotcache.admit(
            tc, hotcache.steer(th, tl, n_threads), th, tl,
            torch.from_numpy(vl[:, 0].view(np.int32).copy()),
            torch.from_numpy(vl[:, 1].view(np.int32).copy()),
            torch.from_numpy(el), cfg=cfg_t, wave=w,
        )
        for f in jc._fields:  # admit state, incl. colliding slots, bitwise
            _eq(getattr(tc, f), getattr(jc, f), f)
    probes = np.concatenate([np.concatenate(admitted)[::7], rng.integers(0, 2**63, 90, dtype=np.uint64)])
    (jh, jl), (th, tl) = _limbs(probes)
    want = jprobe.probe_pallas(jc, jhot.steer(jh, jl, n_threads), jh, jl, cfg=cfg_j, block_requests=probes.size)
    got = ops.cache_probe(tc, hotcache.steer(th, tl, n_threads), th, tl, cfg=cfg_t)
    assert bool(got[0].any()), "admitted keys must probe back"
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("n_threads,n_buckets", [(8, 24), (176, 24), (16, 8)])
def test_cache_probe_p1_matches_pallas(n_threads, n_buckets):
    cfg_j = jscan.ScanCacheConfig(n_threads=n_threads, n_buckets=n_buckets)
    cfg_t = ScanCacheConfig(n_threads=n_threads, n_buckets=n_buckets)
    jc = jscan.make_cache(cfg_j)
    tc = scancache.make_cache(cfg_t, "cpu")
    rng = np.random.default_rng(5)
    admitted = []
    for w in range(4):
        ks, _ = _colliding_wave(rng, 200)
        admitted.append(ks)
        leaves = rng.integers(0, 512, ks.size).astype(np.int32)
        (jh, jl), (th, tl) = _limbs(ks)
        jc = jscan.admit(
            jc, jhot.steer(jh, jl, n_threads), jh, jl, jnp.asarray(leaves),
            jnp.ones(ks.size, bool), cfg=cfg_j, wave=w, epoch=w + 1,
        )
        tc = scancache.admit(
            tc, hotcache.steer(th, tl, n_threads), th, tl, torch.from_numpy(leaves),
            torch.ones(ks.size, dtype=torch.bool), cfg=cfg_t, wave=w, epoch=w + 1,
        )
        for f in jc._fields:
            _eq(getattr(tc, f), getattr(jc, f), f)
    freed = np.unique(np.asarray(jc.bleaf).ravel())[:40].astype(np.int32)
    jc, jn = jscan.invalidate_leaves(jc, jnp.asarray(freed))
    tc, tn = scancache.invalidate_leaves(tc, torch.from_numpy(freed))
    assert tn == int(jn)
    _eq(tc.bvalid, jc.bvalid)
    probes = np.concatenate([np.concatenate(admitted)[::5], rng.integers(0, 2**63, 60, dtype=np.uint64)])
    (jh, jl), (th, tl) = _limbs(probes)
    want = jprobe.anchor_probe_pallas(
        jc, jhot.steer(jh, jl, n_threads), jh, jl, cfg=cfg_j, block_requests=probes.size
    )
    got = ops.scan_anchor_probe(tc, hotcache.steer(th, tl, n_threads), th, tl, cfg=cfg_t)
    assert bool(got[0].any())
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("B", [0, 1, 300, 65536])
@pytest.mark.parametrize("view", ["aligned", "offset"])
@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("W", [2, 4, 8])
def test_probe_plan_is_valid(W, P, view, B):
    """Kernel B2's plan: 16-byte loads of the bucket exactly for the caches'
    layout (4 ways, P = 1 or 2, arrays whose bases allow 16-byte words),
    all at once for waves of at most one CTA per SM and Bloom- and
    match-gated beyond, the generic 32-bit shape for any other layout;
    every shape that serves a layout covers each request with its own
    thread, and no CTA is left without a request."""
    T, NB = 3, 5
    extra = 1 if view == "offset" else 0  # one word in: 4-byte but not 16-byte aligned
    bkey = torch.zeros(T * NB * W * 2 + extra, dtype=torch.int32)[extra:].view(T, NB, W, 2)
    bpay = torch.zeros(T * NB * W * P + extra, dtype=torch.int32)[extra:].view(T, NB, W, P)
    bvalid = torch.zeros(T * NB * W + extra, dtype=torch.bool)[extra:].view(T, NB, W)
    aligned = cache_probe.vector_aligned(bkey, bpay, bvalid)
    assert aligned == (view == "aligned")
    if P == 1:  # the scan cache's leaf ids, passed as a (T, NB, W, 1) view
        assert cache_probe.vector_aligned(bkey, bpay[..., 0][..., None], bvalid) == aligned
    sm = 132
    plan = cache_probe.probe_plan(B, W, P, aligned, sm)
    edge = sm * cache_probe.THREADS  # the largest wave of one CTA per SM
    if W == 4 and P <= 2 and aligned:  # all loads at once up to one CTA per SM
        assert plan.design == ("vector" if B <= edge else "lean")
        assert [cache_probe.probe_plan(b, W, P, aligned, sm).design for b in (edge, edge + 1)] == ["vector", "lean"]
    else:
        assert plan.design == "generic"
    for design in cache_probe.DESIGNS:
        ok = cache_probe.serves(design, W, P, aligned)
        assert ok or design in ("loop", "vector", "gated", "late", "lean")
        if not ok:
            continue
        for threads in (cache_probe.THREADS, 256):
            sh = plan if design == plan.design and threads == cache_probe.THREADS else cache_probe.shape(
                design, B, threads
            )
            assert sh.threads % 32 == 0 and sh.threads <= 256
            assert sh.grid * sh.threads >= B > (sh.grid - 1) * sh.threads or sh.grid == B == 0


def _hand_cache(P, n_threads=8, n_buckets=24, ways=4, bloom_bits=256):
    """Keys placed by hand in the caches' arrays (numpy u32), with the
    hashes of the port: (bloom, bkey, bpay, bvalid) and helpers that set a
    key's way and its Bloom bits."""
    salts, bsalt = (hotcache.SALT_BLOOM, hotcache.SALT_BUCKET) if P == 2 else (
        scancache.SALT_SBLOOM, scancache.SALT_SBUCKET)
    bloom = np.zeros((n_threads, bloom_bits // 32), np.uint32)
    bkey = np.zeros((n_threads, n_buckets, ways, 2), np.uint32)
    bpay = np.zeros((n_threads, n_buckets, ways, P), np.uint32)
    bvalid = np.zeros((n_threads, n_buckets, ways), bool)

    def where(k):
        (_, _), (th, tl) = _limbs(np.array([k], np.uint64))
        t = int(hotcache.steer(th, tl, n_threads)[0])
        b = int(cacheset.bucket_of(u32(th), u32(tl), n_buckets, bsalt)[0])
        bits = [int(h[0]) for h in cacheset.bloom_hashes(u32(th), u32(tl), bloom_bits, salts)]
        return t, b, bits

    def put(k, way, pay, valid=True, held=None):
        """Way ``way`` of key ``k``'s bucket holds key ``held`` (``k``)."""
        t, b, _ = where(k)
        bkey[t, b, way] = split_u64(np.array([k if held is None else held], np.uint64))[0]
        bpay[t, b, way] = pay
        bvalid[t, b, way] = valid

    def mark(k):
        t, _, bits = where(k)
        for h in bits:
            bloom[t, h // 32] |= np.uint32(1) << np.uint32(h % 32)

    return (bloom, bkey, bpay, bvalid), where, put, mark


@pytest.mark.parametrize("case", ["first_match", "bloom_negative"])
@pytest.mark.parametrize("P", [2, 1])
def test_cache_probe_hand_built_states_match_pallas(P, case):
    """Two cache states built by hand, probed by the JAX package's Pallas
    kernel (interpret mode) and by the port (the plain version on the CPU):
    a key held valid in two ways with different payloads (behind an invalid
    copy) answers with the first valid way's payload; a key sitting valid in
    its bucket but Bloom-negative is a miss with a zero payload."""
    rng = np.random.default_rng(11 + P)
    arrays, where, put, mark = _hand_cache(P)
    keys = rng.integers(0, 2**63, 64, dtype=np.uint64)
    slots = {}
    for k in keys:  # keys whose (thread, bucket) no earlier key took
        slots.setdefault(where(int(k))[:2], int(k))
    keys = np.array(sorted(slots.values()), np.uint64)[:12]
    assert keys.size == 12
    want_hit, want_pay = [], []
    for j, k in enumerate(keys.tolist()):
        pay = [[(j << 8) | (w << 4) | p for p in range(P)] for w in range(4)]
        if case == "first_match":
            put(k, 0, pay[0], held=k ^ 0x5A5A)  # another key, valid
            put(k, 1, pay[1], valid=False)  # an invalid copy
            put(k, 2, pay[2])  # the first valid copy: the answer
            put(k, 3, pay[3])
            mark(k)
            want_hit.append(True)
            want_pay.append(pay[2])
        else:
            put(k, 0, pay[0])
            negative = j % 2 == 0  # half of the keys lack a Bloom bit
            if not negative:
                mark(k)
            want_hit.append(not negative)
            want_pay.append([0] * P if negative else pay[0])
    if case == "bloom_negative":  # no other key's bits may cover a negative one's
        bloom = arrays[0]
        for j, k in enumerate(keys.tolist()):
            t, _, bits = where(k)
            if j % 2 == 0:
                bloom[t, bits[0] // 32] &= ~(np.uint32(1) << np.uint32(bits[0] % 32))
    probes = np.concatenate([keys, rng.integers(0, 2**63, 4, dtype=np.uint64)])
    want_hit += [False] * 4
    want_pay += [[0] * P] * 4
    bloom, bkey, bpay, bvalid = arrays
    (jh, jl), (th, tl) = _limbs(probes)
    ti = lambda a: torch.from_numpy(a.view(np.int32).copy())  # noqa: E731
    if P == 2:
        cfg_j, cfg_t = jhot.CacheConfig(n_threads=8), CacheConfig(n_threads=8)
        jc = jhot.make_cache(cfg_j)._replace(bloom=jnp.asarray(bloom), bkey=jnp.asarray(bkey),
                                             bval=jnp.asarray(bpay), bvalid=jnp.asarray(bvalid))
        tc = hotcache.make_cache(cfg_t, "cpu")._replace(bloom=ti(bloom), bkey=ti(bkey), bval=ti(bpay),
                                                       bvalid=torch.from_numpy(bvalid.copy()))
        want = jprobe.probe_pallas(jc, jhot.steer(jh, jl, 8), jh, jl, cfg=cfg_j, block_requests=probes.size)
        got = ops.cache_probe(tc, hotcache.steer(th, tl, 8), th, tl, cfg=cfg_t)
        plain = cache_probe.probe_plain(tc.bloom, tc.bkey, tc.bval, tc.bvalid, hotcache.steer(th, tl, 8), th, tl,
                                        bloom_bits=256, n_buckets=24, salts_bloom=hotcache.SALT_BLOOM,
                                        salt_bucket=hotcache.SALT_BUCKET)
        plain = (plain[0], plain[1][:, 0], plain[1][:, 1])
        pay_got = torch.stack(got[1:], 1)
    else:
        cfg_j, cfg_t = jscan.ScanCacheConfig(n_threads=8), ScanCacheConfig(n_threads=8)
        leaf = bpay[..., 0].view(np.int32)
        jc = jscan.make_cache(cfg_j)._replace(bloom=jnp.asarray(bloom), bkey=jnp.asarray(bkey),
                                              bleaf=jnp.asarray(leaf), bvalid=jnp.asarray(bvalid))
        tc = scancache.make_cache(cfg_t, "cpu")._replace(bloom=ti(bloom), bkey=ti(bkey),
                                                        bleaf=torch.from_numpy(leaf.copy()),
                                                        bvalid=torch.from_numpy(bvalid.copy()))
        want = jprobe.anchor_probe_pallas(jc, jhot.steer(jh, jl, 8), jh, jl, cfg=cfg_j, block_requests=probes.size)
        got = ops.scan_anchor_probe(tc, hotcache.steer(th, tl, 8), th, tl, cfg=cfg_t)
        plain = cache_probe.probe_plain(tc.bloom, tc.bkey, tc.bleaf[..., None], tc.bvalid, hotcache.steer(th, tl, 8),
                                        th, tl, bloom_bits=256, n_buckets=24, salts_bloom=scancache.SALT_SBLOOM,
                                        salt_bucket=scancache.SALT_SBUCKET)
        plain = (plain[0], plain[1][:, 0])
        pay_got = got[1][:, None]
    for g, w, pl in zip(got, want, plain, strict=True):
        _eq(g, w)
        _eq(pl, w)
    _eq(got[0], np.array(want_hit))
    _eq(pay_got, np.array(want_pay, np.uint32))


def test_cache_invalidate_matches():
    cfg_j = jhot.CacheConfig(n_threads=8, n_buckets=8, admit_shift=0)
    cfg_t = CacheConfig(n_threads=8, n_buckets=8, admit_shift=0)
    rng = np.random.default_rng(9)
    ks, vs = _colliding_wave(rng, 200)
    (jh, jl), (th, tl) = _limbs(ks)
    vl = split_u64(vs)
    jc = jhot.admit(jhot.make_cache(cfg_j), jhot.steer(jh, jl, 8), jh, jl,
                    jnp.asarray(vl[:, 0]), jnp.asarray(vl[:, 1]), jnp.ones(ks.size, bool), cfg=cfg_j)
    tc = hotcache.admit(hotcache.make_cache(cfg_t, "cpu"), hotcache.steer(th, tl, 8), th, tl,
                        torch.from_numpy(vl[:, 0].view(np.int32).copy()),
                        torch.from_numpy(vl[:, 1].view(np.int32).copy()),
                        torch.ones(ks.size, dtype=torch.bool), cfg=cfg_t)
    act = rng.random(ks.size) < 0.5
    jc = jhot.invalidate(jc, jhot.steer(jh, jl, 8), jh, jl, jnp.asarray(act), cfg=cfg_j)
    tc = hotcache.invalidate(tc, hotcache.steer(th, tl, 8), th, tl, torch.from_numpy(act), cfg=cfg_t)
    for f in jc._fields:
        _eq(getattr(tc, f), getattr(jc, f), f)


# -------------------------------------------------------- B3: range walk


@pytest.mark.parametrize("limit,max_leaves", [(10, 4), (3, 2), (40, 1)])
def test_range_walk_plain_matches_pallas(limit, max_leaves):
    st, keys, rng = _mk(2000, sparse, churn=90, seed=13)
    tree, _ = _carry(st)
    q = np.concatenate([rng.choice(keys, 24), rng.integers(0, 2**63, 4, dtype=np.uint64), keys[-4:]])
    (jh, jl), (th, tl) = _limbs(q)
    start = jlookup.traverse(st.tree, jh, jl, depth=st.depth, eps_inner=st.cfg.eps_inner)
    start = jnp.where(jnp.arange(q.size) % 5 == 4, -1, start)  # dead lanes
    want = range_pallas(st.tree, start, jh, jl, limit=limit, max_leaves=max_leaves, block_requests=q.size)
    got = range_scan.walk(
        tree, torch.from_numpy(np.asarray(start).copy()), th, tl, limit=limit, max_leaves=max_leaves
    )
    for g, w, name in zip(got, want, ("kh", "kl", "vh", "vl", "n", "visited", "next")):
        _eq(g, w, name)


def test_range_scan_one_round_matches_pallas():
    """One-round RANGE op (walk + merge epilogue) from cached/continuation
    anchors, dead lanes included, == the JAX op on its Pallas kernel."""
    st, keys, rng = _mk(2000, sparse, churn=90, seed=13)
    tree, ib = _carry(st)
    q = rng.choice(keys, 24)
    (jh, jl), (th, tl) = _limbs(q)
    anchor = jlookup.traverse(st.tree, jh, jl, depth=st.depth, eps_inner=st.cfg.eps_inner)
    anchor = jnp.where(jnp.arange(24) % 5 == 4, -1, anchor)
    kw = dict(depth=st.depth, eps_inner=st.cfg.eps_inner, limit=8, max_leaves=3)
    want = jops.range_scan(
        st.tree, st.ib, jh, jl, impl="pallas_interpret", block_requests=24, start_leaf=anchor, **kw
    )
    got = ops.range_scan(tree, ib, th, tl, start_leaf=torch.from_numpy(np.asarray(anchor).copy()), **kw)
    for g, w in zip(got[:4], want[:4]):
        _eq(g, w)
    for f in ("khi", "klo", "leaf"):
        _eq(getattr(got[4], f), getattr(want[4], f), f)


# ------------------------------------------------- RANGE: the full loop


def _check_loop(got, want, what):
    names = ("keys", "vals", "valid", "truncated")
    for g, w, name in zip(got[:4], want[:4], names):
        _eq(g, w, f"{what}:{name}")
    for f in ("khi", "klo", "leaf"):
        _eq(getattr(got[4], f), getattr(want[4], f), f"{what}:cursor.{f}")
    assert int(got[5]) == int(want[5]), f"{what}: rounds {got[5]} != {want[5]}"


@pytest.mark.parametrize("max_leaves", [1, 2, 4])
def test_range_scan_loop_matches_reference(max_leaves):
    st, keys, rng = _mk(2000, sparse, churn=90, seed=13)
    tree, ib = _carry(st)
    q = np.concatenate([rng.choice(keys, 28), rng.integers(0, 2**63, 4, dtype=np.uint64)])
    (jh, jl), (th, tl) = _limbs(q)
    depth, eps = st.depth, st.cfg.eps_inner
    jstart = jlookup.traverse(st.tree, jh, jl, depth=depth, eps_inner=eps)
    tstart = torch.from_numpy(np.asarray(jstart).copy())
    mid = np.sort(keys)[len(keys) // 2]
    ub = split_u64(np.full(q.size, mid, dtype=np.uint64))
    no_ub = jnp.full_like(jh, 0xFFFFFFFF)
    cases = [(40, 0, None), (25, 1, ub)]
    if max_leaves == 1:
        cases += [(40, 1, None), (40, 2, None), (25, 0, ub)]
    for limit, max_rounds, clip in cases:
        j_ub = (no_ub, no_ub) if clip is None else (jnp.asarray(clip[:, 0]), jnp.asarray(clip[:, 1]))
        t_ub = {} if clip is None else dict(
            ub_hi=torch.from_numpy(clip[:, 0].view(np.int32).copy()),
            ub_lo=torch.from_numpy(clip[:, 1].view(np.int32).copy()),
        )
        want = jlookup.range_batch_loop(
            st.tree, st.ib, jstart, jh, jl, *j_ub,
            limit=limit, max_leaves=max_leaves, max_rounds=max_rounds,
        )
        got = ops.range_scan_loop(
            tree, ib, th, tl, depth=depth, eps_inner=eps, limit=limit,
            max_leaves=max_leaves, max_rounds=max_rounds, **t_ub,
        )
        what = f"limit={limit} rounds<={max_rounds} clip={clip is not None}"
        _check_loop(got, want, what)
        if max_leaves == 1 and max_rounds == 0 and clip is None:
            assert int(got[5]) > 1, "max_leaves=1 over limit=40 must loop"
        # the port's plain-torch loop is the same function
        plain = lookup.range_batch_loop(
            tree, ib, tstart, th, tl,
            t_ub.get("ub_hi", torch.full_like(th, -1)), t_ub.get("ub_lo", torch.full_like(tl, -1)),
            limit=limit, max_leaves=max_leaves, max_rounds=max_rounds,
        )
        _check_loop(plain, want, what + " plain")


def test_range_scan_loop_matches_pallas_loop():
    st, keys, rng = _mk(2000, sparse, churn=90, seed=13)
    tree, ib = _carry(st)
    q = np.concatenate([rng.choice(keys, 12), keys[-2:]])
    (jh, jl), (th, tl) = _limbs(q)
    kw = dict(depth=st.depth, eps_inner=st.cfg.eps_inner, limit=20, max_leaves=2)
    want = jops.range_scan_loop(st.tree, st.ib, jh, jl, impl="pallas_interpret", block_requests=q.size, **kw)
    got = ops.range_scan_loop(tree, ib, th, tl, **kw)
    _check_loop(got, want, "pallas loop")
