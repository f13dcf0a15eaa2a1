"""Port foundations == JAX package: the host image, the device pools, the
limb hashes and the saturating float->int32 conversion, and the state
carry functions.  CPU only; every comparison is exact (bitwise)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DPAStore as JaxStore
from repro.core import datasets as jds
from repro.core import hotcache as jhot
from repro.core import keys as jkeys
from repro.core import tree as jtree
from repro_torch.core import carry, datasets, hotcache, keys, tree

DATASETS = ["sparse", "dense4x", "osmc", "face"]


def _as_np(x):
    return x if isinstance(x, np.ndarray) else np.asarray(x)


def _bits(a: np.ndarray) -> np.ndarray:
    """Bit pattern view for an exact comparison (floats included)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.bool_:
        return a
    return a.view({1: np.uint8, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


@pytest.mark.parametrize("name", DATASETS)
def test_datasets_are_copies(name):
    np.testing.assert_array_equal(datasets.DATASETS[name](2500, 3), jds.DATASETS[name](2500, 3))


@pytest.mark.parametrize("name", DATASETS)
def test_build_image_matches(name):
    ks = datasets.DATASETS[name](3000, 5)
    vs = ks ^ np.uint64(0x5A5A)
    cfg_t = tree.TreeConfig(eps_inner=4, eps_leaf=8)
    cfg_j = jtree.TreeConfig(eps_inner=4, eps_leaf=8)
    a = tree.build_image(ks, vs, cfg_t)
    b = jtree.build_image(ks, vs, cfg_j)
    for f in dataclasses.fields(b):
        if f.name == "cfg":
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(_bits(va), _bits(vb), err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("name", DATASETS)
def test_device_pools_match_bitwise(name):
    ks = datasets.DATASETS[name](3000, 9)
    vs = ks + np.uint64(1)
    a = carry.tree_to_numpy(tree.build_image(ks, vs).to_device("cpu"))
    jt = jtree.build_image(ks, vs).to_device()
    for f in jt._fields:
        np.testing.assert_array_equal(_bits(a[f]), _bits(np.asarray(getattr(jt, f))), err_msg=f)


def test_limb_hash_and_steer_match():
    rng = np.random.default_rng(1)
    ks = np.concatenate(
        [rng.integers(0, 2**64, 4000, dtype=np.uint64), np.array([0, 2**64 - 1], dtype=np.uint64)]
    )
    limbs = keys.split_u64(ks)
    jh, jl = jnp.asarray(limbs[:, 0]), jnp.asarray(limbs[:, 1])
    th, tl = keys.u32(torch.from_numpy(limbs.view(np.int32)[:, 0].copy())), keys.u32(
        torch.from_numpy(limbs.view(np.int32)[:, 1].copy())
    )
    for salt in (0, 1, 2, 3, 4, 5, 6, 21, 22, 23, 24, 25, 26):
        want = np.asarray(jkeys.limb_hash(jh, jl, salt))
        np.testing.assert_array_equal(keys.limb_hash(th, tl, salt).numpy().astype(np.uint32), want)
        np.testing.assert_array_equal(keys.limb_hash_np(ks, salt), want)
    for n_threads in (8, 176):
        want = np.asarray(jhot.steer(jh, jl, n_threads))
        got = hotcache.steer(
            torch.from_numpy(limbs.view(np.int32)[:, 0].copy()),
            torch.from_numpy(limbs.view(np.int32)[:, 1].copy()),
            n_threads,
        )
        np.testing.assert_array_equal(got.numpy(), want)


def test_saturating_floor_matches_reference_cast():
    """Hazard: a plain int32 cast wraps far predictions; the reference
    saturates them.  Values from real far queries lie beyond 2^31."""
    x = np.array(
        [3e10, 2.0**31, 2.0**31 - 128, -3e10, np.inf, -np.inf, np.nan, 1.5, -0.0, 4e9, 0.999],
        dtype=np.float32,
    )
    want = np.asarray(jnp.floor(jnp.asarray(x)).astype(jnp.int32))
    got = keys.floor_to_i32_saturating(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_carry_round_trips():
    ks = datasets.sparse(2000, 4)
    st = JaxStore(ks, ks + np.uint64(3))
    st.put(ks[:300:3], ks[:300:3])
    st.get(ks[:400])
    st.range(ks[:50], limit=12)
    for state, to_t, to_n in (
        (st.tree, carry.tree_from_numpy, carry.tree_to_numpy),
        (st.ib, carry.ib_from_numpy, carry.ib_to_numpy),
        (st.cache, carry.cache_from_numpy, carry.cache_to_numpy),
        (st.scan_cache, carry.scan_cache_from_numpy, carry.scan_cache_to_numpy),
    ):
        d = {f: np.asarray(getattr(state, f)) for f in state._fields}
        back = to_n(to_t(d, "cpu"))
        assert set(back) == set(d)
        for f in d:
            assert back[f].dtype == d[f].dtype, f
            np.testing.assert_array_equal(back[f], d[f], err_msg=f)
