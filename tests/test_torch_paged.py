"""Port paged KV cache path == JAX paged KV cache path.

Kernel B4's plain versions (one pool, and the K and V pair) against JAX
``gather_ref`` and ``gather_pallas`` (interpret mode), B4's launch plan,
``decode_attention``, ``PagedCache`` over one seeded
interleaved append stream, ``PagedAttentionLayer.attend`` and the carry of a
whole cache, all at a small size (block_size 4, 2 KV heads, head_dim 8,
64 blocks, bf16 pools).  Inputs are made with numpy from a seed and fed to
both packages.  Gathers, pools, slot lists and page-table ``StoreStats`` are
compared bitwise; attention outputs (f32) at rtol = atol = 1e-5, since the
two frameworks sum the score and value products in different orders.  On the
CPU the port's wrappers run their kernels' plain versions; the card test of
kernel B4 is in ``test_torch_boundaries.py``, which imports no JAX and so
also runs on a machine with a card."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import paged_gather as jgather
from repro.models.layers import decode_attention as jdecode
from repro.serving.engine import PagedAttentionLayer as JaxLayer
from repro.serving.paged_cache import PagedCache as JaxCache
from repro_torch.kernels import paged_gather
from repro_torch.models.layers import decode_attention
from repro_torch.serving.engine import PagedAttentionLayer
from repro_torch.serving import paged_cache
from repro_torch.serving.paged_cache import PagedCache

BS, HKV, HD, NB = 4, 2, 8, 64
TOL = dict(rtol=1e-5, atol=1e-5)


def _bits(a) -> np.ndarray:
    """Bit patterns of a pool or gather result, from either package."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _kv(rng, n):
    return [rng.normal(size=(HKV, HD)).astype(np.float32) for _ in range(n)]


def _jax_to_numpy(jpc):
    return {
        "pool_k": np.asarray(jpc.pool_k),
        "pool_v": np.asarray(jpc.pool_v),
        "free": list(jpc.free),
        "seq_len": dict(jpc.seq_len),
        "items": jpc.table.items(),
    }


# ------------------------------------------------------------- B4: gather

_EDGE = [-1, NB, NB + 3, -NB - 1, 2**31 - 1, -(2**31)]


@pytest.mark.parametrize("pools", ["one", "kv"])
@pytest.mark.parametrize("slots", ["random", "edges", "empty"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gather_plain_matches_jax(dtype, slots, pools):
    """One pool through ``gather`` (JAX's ``gather``), or a K and V pair
    through ``gather_kv`` (JAX's ``gather`` applied to each pool)."""
    rng = np.random.default_rng(1)
    np_pools = [rng.normal(size=(NB, BS, HKV, HD)).astype(np.float32) for _ in range(1 if pools == "one" else 2)]
    if dtype == "bf16":
        np_pools = [p.astype(ml_dtypes.bfloat16) for p in np_pools]
    idx = {
        "random": rng.integers(0, NB, 37),
        "edges": np.array(_EDGE + [3, 0, NB - 1]),
        "empty": np.zeros(0),
    }[slots].astype(np.int32)
    tpools = [paged_cache._pool_from_numpy(p, "cpu") for p in np_pools]
    ts = torch.from_numpy(idx)
    got = [paged_gather.gather(tpools[0], ts)] if pools == "one" else list(paged_gather.gather_kv(*tpools, ts))
    if pools == "kv":
        for g, want in zip(got, paged_gather.gather_kv_plain(*tpools, ts)):
            assert torch.equal(g, want)
    js = jnp.asarray(idx)
    for g, pool, tpool in zip(got, np_pools, tpools, strict=True):
        jp = jnp.asarray(pool)
        assert g.shape == (idx.size, BS, HKV, HD) and g.dtype == tpool.dtype
        np.testing.assert_array_equal(_bits(g), _bits(jgather.gather(jp, js, impl="ref")))
        if idx.size:
            np.testing.assert_array_equal(_bits(g), _bits(jgather.gather_ref(jp, js)))
            np.testing.assert_array_equal(_bits(g), _bits(jgather.gather_pallas(jp, js, interpret=True)))


@pytest.mark.parametrize("n_pools", [1, 2])
@pytest.mark.parametrize("n", [1, 7, 59, 131, 133, 1000, 16384])
@pytest.mark.parametrize("block_bytes,aligned", [(32768, True), (32768, False), (210, False), (1, False)])
def test_gather_launch_plan_covers_every_byte_once(block_bytes, aligned, n, n_pools):
    """Kernel B4's launch plan, read the way the kernel reads it: CTA c takes
    items c, c + grid, ...; item i is chunk ``i % chunks`` of listed slot
    ``(i // chunks) % n`` of pool ``i // (chunks * n)``, the bytes
    [chunk * c, min(chunk * (c + 1), block_bytes)).  Every byte of every
    listed block of every pool is copied exactly once; the bulk path only for
    aligned lists that are in flight at once."""
    sm = 132
    plan = paged_gather.launch_plan(block_bytes, n, n_pools, sm, aligned)
    assert plan.chunk % 16 == 0 and plan.chunk <= paged_gather.CHUNK
    assert plan.chunks == -(-block_bytes // plan.chunk)
    assert plan.items == n_pools * n * plan.chunks and 1 <= plan.grid <= plan.items
    taken = np.concatenate([np.arange(c, plan.items, plan.grid) for c in range(plan.grid)])
    np.testing.assert_array_equal(np.sort(taken), np.arange(plan.items))  # each item once
    i = np.arange(plan.items)
    chunk, j, p = i % plan.chunks, (i // plan.chunks) % n, i // (plan.chunks * n)
    start = chunk * plan.chunk
    stop = np.minimum(start + plan.chunk, block_bytes)
    assert (stop > start).all()
    order = np.lexsort((start, j, p))
    same_block = (p[order][1:] == p[order][:-1]) & (j[order][1:] == j[order][:-1])
    np.testing.assert_array_equal(start[order][1:][same_block], stop[order][:-1][same_block])  # no gap, no overlap
    firsts, lasts = start[order][np.r_[True, ~same_block]], stop[order][np.r_[~same_block, True]]
    assert firsts.size == n_pools * n and (firsts == 0).all() and (lasts == block_bytes).all()
    ring = paged_gather.STAGES * plan.chunk
    resident = sm * min(paged_gather.CTAS_PER_SM, paged_gather.SMEM_PER_SM // (ring + 1024))
    assert plan.bulk == (aligned and plan.items <= paged_gather.STAGES * resident)
    if plan.bulk:  # one-warp CTAs that the SMs hold at once, each streaming <= STAGES items
        assert plan.threads == 32 and plan.smem == ring <= 227 * 1024
        assert plan.grid == min(plan.items, resident)
    else:  # one CTA per item
        assert plan.threads == paged_gather.WORD_THREADS and plan.smem == 0 and plan.grid == plan.items


def test_gather_returns_a_fresh_buffer():
    pool = torch.arange(NB * BS * HKV * HD, dtype=torch.float32).reshape(NB, BS, HKV, HD)
    out = paged_gather.gather(pool, torch.tensor([2, 5], dtype=torch.int32))
    pool.zero_()
    assert bool(out.ne(0).any())


# ------------------------------------------------------ decode attention


@pytest.mark.parametrize("valid_len", [9, [12, 7], [0, 5]])
def test_decode_attention_matches_jax(valid_len):
    rng = np.random.default_rng(2)
    B, S, H = 2, 12, 2 * HKV  # GQA: G = 2
    q = rng.normal(size=(B, 1, H, HD)).astype(np.float32)
    k = rng.normal(size=(B, S, HKV, HD)).astype(ml_dtypes.bfloat16)
    v = rng.normal(size=(B, S, HKV, HD)).astype(ml_dtypes.bfloat16)
    vl = valid_len if isinstance(valid_len, int) else np.asarray(valid_len, np.int32)
    want = np.asarray(jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), vl if isinstance(vl, int) else jnp.asarray(vl)))
    got = decode_attention(
        torch.from_numpy(q),
        paged_cache._pool_from_numpy(k, "cpu"),
        paged_cache._pool_from_numpy(v, "cpu"),
        vl if isinstance(vl, int) else torch.from_numpy(vl),
    )
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, HD)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------------------ PagedCache


def _eq_caches(t: PagedCache, j: JaxCache, what: str):
    d = t.to_numpy()
    np.testing.assert_array_equal(d["pool_k"].view(np.int16), _bits(j.pool_k), err_msg=what)
    np.testing.assert_array_equal(d["pool_v"].view(np.int16), _bits(j.pool_v), err_msg=what)
    assert list(d["free"]) == list(j.free), what
    assert d["seq_len"] == j.seq_len, what
    assert dataclasses.asdict(t.table.stats) == dataclasses.asdict(j.table.stats), what


def _eq_reads(t: PagedCache, j: JaxCache, seqs, what: str):
    for s in seqs:
        np.testing.assert_array_equal(t.lookup_slots(s), j.lookup_slots(s), err_msg=f"{what} slots {s}")
        tk, tv, tn = t.gather(s)
        jk, jv, jn = j.gather(s)
        assert tn == jn, what
        np.testing.assert_array_equal(_bits(tk), _bits(jk), err_msg=f"{what} gather k {s}")
        np.testing.assert_array_equal(_bits(tv), _bits(jv), err_msg=f"{what} gather v {s}")


def _append_both(t, j, rng, lengths):
    """Interleaved appends: one token per live sequence per step."""
    for step in range(max(lengths.values())):
        for s, n in lengths.items():
            if step < n:
                k, v = _kv(rng, 2)
                t.append(s, torch.from_numpy(k), torch.from_numpy(v))
                j.append(s, jnp.asarray(k), jnp.asarray(v))


def test_paged_cache_differential():
    """The same interleaved stream through both caches: 36 block PUTs fill
    the page table's insert buffer past ib_cap (a flush cycle runs), then a
    release and a re-append reuse the freed blocks.  Sequences share block
    counts so that the JAX store compiles few RANGE shapes."""
    rng = np.random.default_rng(3)
    t = PagedCache(NB, BS, HKV, HD, device="cpu")
    j = JaxCache(NB, BS, HKV, HD)
    lengths = {1: 50, 2: 40, 7: 49}
    _append_both(t, j, rng, lengths)
    _eq_caches(t, j, "after appends")
    assert t.table.stats.flush_cycles >= 1
    _eq_reads(t, j, lengths, "after appends")
    _eq_caches(t, j, "after reads")
    assert t.release(2) == j.release(2) == 10
    assert t.release(5) == j.release(5) == 0  # unknown sequence
    freed = set(t.free[-10:])
    _append_both(t, j, rng, {9: 40, 1: 2})
    _eq_caches(t, j, "after re-append")
    _eq_reads(t, j, [1, 7, 9], "after re-append")
    assert set(t.lookup_slots(9)) == freed and set(j.lookup_slots(9)) == freed
    assert t.lookup_slots(2).size == j.lookup_slots(2).size == 0
    _eq_caches(t, j, "final")


def test_paged_attention_layer_matches_jax():
    rng = np.random.default_rng(4)
    t = PagedAttentionLayer(HKV, HD, block_size=BS, n_blocks=NB, device="cpu")
    j = JaxLayer(HKV, HD, block_size=BS, n_blocks=NB)
    _append_both(t.cache, j.cache, rng, {42: 13, 3: 16})
    for s in (42, 3):
        q = rng.normal(size=(2 * HKV, HD)).astype(np.float32)  # GQA 2:1
        got = t.attend(s, torch.from_numpy(q))
        want = np.asarray(j.attend(s, jnp.asarray(q)))
        assert got.shape == (2 * HKV, HD)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_carry_paged_cache():
    """A JAX cache carried over bit for bit: equal lookups, gathers and
    attention, and equal slots for blocks appended after the carry."""
    rng = np.random.default_rng(5)
    j = JaxLayer(HKV, HD, block_size=BS, n_blocks=NB)
    for s, n in ((4, 13), (8, 40), (6, 16)):
        for k, v in zip(_kv(rng, n), _kv(rng, n)):
            j.append(s, jnp.asarray(k), jnp.asarray(v))
    j.cache.release(8)
    t = PagedAttentionLayer(HKV, HD, block_size=BS, n_blocks=NB, device="cpu")
    t.cache = PagedCache.from_numpy(_jax_to_numpy(j.cache), "cpu")
    _eq_reads(t.cache, j.cache, [4, 6], "carried")
    for s in (4, 6):
        q = rng.normal(size=(2 * HKV, HD)).astype(np.float32)
        np.testing.assert_allclose(
            t.attend(s, torch.from_numpy(q)).numpy(), np.asarray(j.attend(s, jnp.asarray(q))), **TOL
        )
    _append_both(t.cache, j.cache, rng, {11: 16, 4: 3})
    _eq_reads(t.cache, j.cache, [4, 6, 11], "appended after the carry")
    d = t.cache.to_numpy()
    np.testing.assert_array_equal(d["pool_k"].view(np.int16), _bits(j.cache.pool_k))
    assert list(d["free"]) == list(j.cache.free)


def test_paged_cache_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedCache(NB, BS, HKV, HD)
