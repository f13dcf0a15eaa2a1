"""The port's B+-tree baseline and ROLEX model == the JAX package's, on the CPU.

Twins of the btree and rolex tests of ``tests/test_btree_perfmodel.py``,
and the pools and answers of ``core/btree.py`` held bit for bit against
the reference's ``build`` / ``get_batch`` on the same keys and queries
(absent keys and keys next to KEY_MAX among them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import btree as jbtree
from repro.core import rolex_model as jrolex
from repro.core.keys import split_u64 as jsplit_u64
from repro_torch.core import btree, perfmodel, rolex_model
from repro_torch.core.datasets import sparse
from repro_torch.core.keys import KEY_MAX, join_u64, split_u64


def _limbs(q):
    limbs = split_u64(q).view(np.int32)
    return torch.from_numpy(limbs[:, 0].copy()), torch.from_numpy(limbs[:, 1].copy())


def _get(bt, q):
    vh, vl, found = btree.get_batch(bt, *_limbs(q))
    got = join_u64(np.stack([vh.numpy(), vl.numpy()], axis=-1))
    return got, found.numpy()


def test_btree_lookup_matches_oracle():
    keys = sparse(5000, seed=41)
    vals = keys ^ np.uint64(7)
    bt = btree.build(keys, vals, device="cpu")
    q = np.concatenate([keys[::37], keys[::41] + np.uint64(1)])
    got, found = _get(bt, q)
    oracle = set(keys.tolist())
    for i, k in enumerate(q.tolist()):
        if k in oracle:
            assert found[i] and got[i] == (k ^ 7)
        else:
            assert not found[i]


def test_btree_depth_fully_packed():
    keys = np.arange(128 * 128 + 1, dtype=np.uint64)  # forces depth 3
    bt = btree.build(keys, keys, device="cpu")
    assert bt.depth == 3
    assert bt.n_leaves == 129


def test_btree_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    keys = np.arange(1, 300, dtype=np.uint64)
    with pytest.raises(RuntimeError, match="CUDA"):
        btree.build(keys, keys)


def _global_children(bt):
    """The reference's tree with each inner level's child ids raised by the
    next inner level's base: its ``get_batch`` then descends as the port's."""
    child = np.asarray(bt.node_child).copy()
    bases = bt.level_base + (child.shape[0],)
    for lvl in range(len(bt.level_base) - 1):
        child[bases[lvl] : bases[lvl + 1]] += bt.level_base[lvl + 1]
    return bt._replace(node_child=jnp.asarray(child))


@pytest.mark.parametrize("n", [1, 128, 5000, 20_000])
def test_btree_pools_and_answers_equal_jax_bitwise(n):
    """``build``'s pools (node keys and children, leaf keys and values,
    level bases, depth) and ``get_batch``'s answers == the reference's, bit
    for bit: present keys, absent ones between them, 0, and the keys next to
    KEY_MAX (KEY_MAX itself descends through a padding slot and its clamped
    gathers answer as the reference's do).  One leaf (the trivial root), one
    full leaf, 5000 keys (depth 2), and 20k keys (depth 3, a partly filled
    last node), where the reference's ``get_batch`` reads the root's child
    ids as pool ids and misses every present key: there the port is held to
    the reference's ``get_batch`` on its pools with those ids made pool ids."""
    keys = sparse(n, seed=7) if n > 1 else np.array([12345], np.uint64)
    vals = keys * np.uint64(0x9E3779B97F4A7C15)
    want = jbtree.build(keys, vals)
    got = btree.build(keys, vals, device="cpu")
    assert (got.depth, got.level_base, got.n_leaves) == (want.depth, want.level_base, want.n_leaves)
    for f in ("node_keys", "node_child", "leaf_keys", "leaf_vals"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.shape == b.shape and b.dtype == np.int32, f
        np.testing.assert_array_equal(b, a.view(np.int32), err_msg=f)
    if want.depth >= 3:
        jl = jsplit_u64(keys[:512])
        assert not np.asarray(jbtree.get_batch(want, jnp.asarray(jl[:, 0]), jnp.asarray(jl[:, 1]))[2]).all()
        want = _global_children(want)
    rng = np.random.default_rng(n)
    q = np.concatenate([
        rng.choice(keys, 512), keys[:: max(1, n // 64)] + np.uint64(1), rng.integers(0, 2**64 - 1, 256, dtype=np.uint64),
        np.array([0, 1, KEY_MAX, KEY_MAX - np.uint64(1), KEY_MAX - np.uint64(2), keys[-1], keys[0]], np.uint64),
    ])
    jl = jsplit_u64(q)
    jvh, jvl, jfound = jbtree.get_batch(want, jnp.asarray(jl[:, 0]), jnp.asarray(jl[:, 1]))
    vh, vl, found = btree.get_batch(got, *_limbs(q))
    np.testing.assert_array_equal(vh.numpy(), np.asarray(jvh).view(np.int32))
    np.testing.assert_array_equal(vl.numpy(), np.asarray(jvl).view(np.int32))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    assert found.numpy()[:512].all()
    got_v, _ = _get(got, q[:512])
    np.testing.assert_array_equal(got_v, vals[np.searchsorted(keys, q[:512])])


def test_access_counts_equal_jax():
    assert btree.inner_lines_touched() == jbtree.inner_lines_touched()
    assert btree.leaf_dmas_touched() == jbtree.leaf_dmas_touched()


def test_btree_vs_learned_access_model():
    """Fig 12 shape: learned beats B+-tree on DMA-bound leaves."""
    hw = perfmodel.HwParams()
    learned_leaf_us = (hw.dpa_ns + 2 * hw.dma_ns) / 1000
    btree_leaf_us = (btree.leaf_dmas_touched() + 0) * hw.dma_ns / 1000
    assert btree_leaf_us > learned_leaf_us
    # inner nodes: 4.5 lines vs 6 lines
    assert btree.inner_lines_touched() > perfmodel.inner_node_lines(4)


def test_rolex_model_shape():
    """Fig 15 qualitative relations the model must reproduce."""
    p = rolex_model.RolexParams()
    # DPA-Store beats ROLEX GET on sparse/amzn; ROLEX wins on osmc (eps fit)
    dpa_get = perfmodel.get_mops(3)
    assert rolex_model.get_mops("sparse", p) < dpa_get
    assert rolex_model.get_mops("amzn", p) < dpa_get
    dpa_get_osmc = perfmodel.get_mops(3, eps_inner=16, eps_leaf=16)
    assert rolex_model.get_mops("osmc", p) > dpa_get_osmc
    # ROLEX INSERT decisively beats DPA-Store's stitch-bound 1.7 MOPS
    assert rolex_model.insert_mops(p) > 4 * perfmodel.insert_mops(70.0)
    # DPA-Store RANGE beats ROLEX ranges everywhere (paper: all RANGE-only)
    assert perfmodel.range_mops(3) > rolex_model.range_mops(10, p)
    # latency: ROLEX GET latency above DPA-Store's traversal latency at QD32
    assert rolex_model.get_latency_us(32, p) > perfmodel.get_time_us(3)


def test_rolex_model_equals_jax():
    """Every number of the copy == the reference's."""
    p, jp = rolex_model.RolexParams(), jrolex.RolexParams()
    assert p.__dict__ == jp.__dict__
    for ds in ("sparse", "sparseBig", "dense4x", "wiki", "amzn", "osmc", "face", "other"):
        assert rolex_model.get_mops(ds, p) == jrolex.get_mops(ds, jp)
        for w in "ABCDEF":
            assert rolex_model.ycsb_mops(w, ds, p) == jrolex.ycsb_mops(w, ds, jp)
    assert rolex_model.insert_mops(p) == jrolex.insert_mops(jp)
    assert rolex_model.update_mops(p) == jrolex.update_mops(jp)
    for limit in (1, 10, 100):
        assert rolex_model.range_mops(limit, p) == jrolex.range_mops(limit, jp)
    for qd in (1, 32):
        assert rolex_model.get_latency_us(qd, p) == jrolex.get_latency_us(qd, jp)
    assert rolex_model.client_state_bytes(500_000_000, p) == jrolex.client_state_bytes(500_000_000, jp)
