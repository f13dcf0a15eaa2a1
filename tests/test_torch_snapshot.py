"""The port's checkpoint manager and store snapshots against the JAX
package, on the CPU.

* ``CheckpointManager`` round-trips a tree of tensors (dicts in sorted-key
  order, lists, tuples, NamedTuples, ``None``), bf16 through its same-width
  integer view, with the reference's on-disk layout: ``step_%09d``, the
  ``.tmp`` directory renamed on commit, ``arr_%06d.npy``, META's fields.
  ``restore`` returns tensors on ``like``'s device (or the one
  ``shardings`` names); ``save`` takes its host copy before the writer
  thread starts; ``clean_tmp`` and the ``keep`` GC act as the reference's.
* A checkpoint written by either package restores in the other.
* ``save_snapshot`` / ``restore_store`` restore a store at any shard count
  with the same ``items()``, and a snapshot written by the JAX package
  restores through the port's ``restore_store`` (and the reverse) with
  equal ``items()``."""

import json
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.core import TreeConfig as JaxTreeConfig
from repro.core.datasets import sparse
from repro.distributed import kvshard as jkv
from repro.distributed import snapshot as jsnap
from repro_torch.checkpoint.manager import CheckpointManager, tree_flatten
from repro_torch.core import DPAStore, TreeConfig
from repro_torch.distributed import kvshard, snapshot

pytestmark = pytest.mark.timeout(300)


class Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def _state():
    g = torch.Generator().manual_seed(0)
    return {
        "w": torch.randn((4, 8), generator=g).to(torch.bfloat16),
        "step": torch.tensor(7, dtype=torch.int64),
        "opt": [torch.arange(5, dtype=torch.int32), (torch.ones(3, dtype=torch.bool), None)],
        "pair": Pair(torch.full((2,), 3.5), torch.tensor([2**63 - 1, -5], dtype=torch.int64)),
        "keys": np.array([1, 2**64 - 2], dtype=np.uint64),
    }


def _equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            np.testing.assert_array_equal(x, y)


def test_round_trip_with_bf16_through_the_integer_view(tmp_path):
    ck = CheckpointManager(tmp_path / "ck")
    state = _state()
    ck.save(3, state, blocking=True)
    d = tmp_path / "ck" / "step_000000003"
    meta = json.loads((d / "META.json").read_text())
    assert set(meta) == {"step", "n_leaves", "treedef", "shapes", "dtypes"}
    # flatten order: sorted dict keys, then sequences in order
    assert meta["dtypes"] == ["uint64", "int32", "bool", "float32", "int64", "int64", "bfloat16"]
    assert np.load(d / "arr_000006.npy").dtype == np.uint16  # bf16's integer view
    _equal(ck.restore(3, state), state)
    meta2, leaves = ck.restore_arrays(3)
    assert meta2 == meta and leaves[6].dtype == torch.bfloat16 and torch.equal(leaves[6], state["w"])


def test_save_takes_its_host_copy_before_the_writer_thread(tmp_path):
    ck = CheckpointManager(tmp_path / "ck")
    t = torch.arange(1 << 16, dtype=torch.int64)
    a = np.arange(8)
    ck.save(1, {"t": t, "a": a})  # not blocking
    t.add_(1)  # in place, while the writer may still run
    a += 1
    ck.wait()
    got = ck.restore(1, {"t": t, "a": a})
    assert torch.equal(got["t"], torch.arange(1 << 16)) and (got["a"] == np.arange(8)).all()


def test_atomic_commit_clean_tmp_and_keep(tmp_path):
    ck = CheckpointManager(tmp_path / "ck", keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.full((4,), s)}, blocking=True)
    assert ck.all_steps() == [3, 4]
    crash = tmp_path / "ck" / "step_000000007.tmp"  # a crashed write
    crash.mkdir()
    (crash / "arr_000000.npy").write_bytes(b"garbage")
    assert ck.latest_step() == 4
    assert ck.clean_tmp() == 1 and not crash.exists()
    jck = JaxManager(tmp_path / "ck")
    assert jck.all_steps() == ck.all_steps()


def test_restore_places_tensors_on_the_named_device(tmp_path):
    ck = CheckpointManager(tmp_path / "ck")
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    ck.save(1, state, blocking=True)
    got = ck.restore(1, {"w": torch.zeros((2, 3), dtype=torch.float64)}, shardings={"w": torch.device("cpu")})
    assert got["w"].dtype == torch.float64 and torch.equal(got["w"], state["w"].double())
    with pytest.raises(AssertionError):
        ck.restore(1, {"w": torch.zeros(3)})


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A JAX-written checkpoint (bf16 included) restores in the port, and a
    port-written one in the JAX package, leaf for leaf."""
    jstate = {"b": {"c": jnp.ones((3, 3), jnp.bfloat16) * 1.5}, "a": jnp.arange(10), "k": jnp.array([True, False])}
    JaxManager(tmp_path / "j").save(2, jstate, blocking=True)
    like = {"a": torch.zeros(10, dtype=torch.int32), "b": {"c": torch.zeros((3, 3), dtype=torch.bfloat16)},
            "k": torch.zeros(2, dtype=torch.bool)}
    got = CheckpointManager(tmp_path / "j").restore(2, like)
    assert torch.equal(got["b"]["c"], torch.full((3, 3), 1.5, dtype=torch.bfloat16))
    assert got["a"].tolist() == list(range(10)) and got["k"].tolist() == [True, False]
    state = _state()
    CheckpointManager(tmp_path / "t").save(5, state, blocking=True)
    meta, leaves = JaxManager(tmp_path / "t").restore_arrays(5)
    for x, y in zip(tree_flatten(state)[0], leaves):
        want = x.float().numpy() if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 else np.asarray(x)
        np.testing.assert_array_equal(np.asarray(y, dtype=want.dtype), want)
    jlike = {
        "w": jnp.zeros((4, 8), jnp.bfloat16), "step": np.int64(0), "keys": np.zeros(2, np.uint64),
        "opt": [np.zeros(5, np.int32), (np.zeros(3, bool), None)],
        "pair": Pair(np.zeros(2, np.float32), np.zeros(2, np.int64)),
    }
    jl = JaxManager(tmp_path / "t").restore(5, jlike)
    np.testing.assert_array_equal(np.asarray(jl["pair"].a), state["pair"].a.numpy())
    np.testing.assert_array_equal(np.asarray(jl["opt"][0]), state["opt"][0].numpy())
    np.testing.assert_array_equal(np.asarray(jl["w"], dtype=np.float32), state["w"].float().numpy())


# ---------------------------------------------------------------------------
# store snapshots
# ---------------------------------------------------------------------------


def _range_facade(keys, n, pkg="port"):
    if pkg == "port":
        return kvshard.ShardedDPAStore(keys, keys ^ np.uint64(0xBEEF), n, TreeConfig(growth=16.0),
                                       partition="range", cache_cfg=None, device="cpu")
    return jkv.ShardedDPAStore(keys, keys ^ np.uint64(0xBEEF), n, JaxTreeConfig(growth=16.0),
                               partition="range", cache_cfg=None)


def test_snapshot_restores_at_any_shard_count(tmp_path):
    keys = sparse(1000, seed=41)
    st = _range_facade(keys, 2)
    fresh = np.unique(np.random.default_rng(1).integers(1, 2**63, 40, dtype=np.uint64))
    st.put(fresh, fresh)
    st.delete(keys[:10])
    want = st.items()
    assert snapshot.save_snapshot(st, tmp_path / "s", step=4) == 4
    snap = snapshot.load_snapshot(tmp_path / "s")
    assert (snap.partition, snap.n_shards, snap.replication, snap.n_keys) == ("range", 2, 1, want[0].size)
    for n in (0, 1, 3, 4):
        r = snapshot.restore_store(tmp_path / "s", n_shards=n, tree_cfg=TreeConfig(growth=16.0), device="cpu",
                                   cache_cfg=None)
        assert isinstance(r, DPAStore) == (n == 0)
        got = r.items()
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    h = snapshot.restore_store(snap, n_shards=3, partition="hash", device="cpu", cache_cfg=None)
    assert h.partition == "hash" and h.device == torch.device("cpu")
    np.testing.assert_array_equal(h.items()[0], want[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            snapshot.restore_store(snap, n_shards=2)  # the card, unless asked for the CPU


def test_snapshots_cross_between_the_packages(tmp_path):
    """The JAX package's snapshot of a replicated range facade restores
    through the port's ``restore_store`` at another shard count with equal
    ``items()``, and the port's snapshot through the reference's."""
    keys = sparse(900, seed=42)
    j = _range_facade(keys, 3, "jax")
    j.put(keys[:20] + np.uint64(1), keys[:20])
    jsnap.save_snapshot(j, tmp_path / "j")
    mine = snapshot.restore_store(tmp_path / "j", n_shards=2, device="cpu", cache_cfg=None)
    for a, b in zip(mine.items(), j.items()):
        np.testing.assert_array_equal(a, np.asarray(b))
    for f in ("keys", "vals", "boundaries", "primary", "in_sync"):
        np.testing.assert_array_equal(getattr(snapshot.load_snapshot(tmp_path / "j"), f),
                                      getattr(jsnap.load_snapshot(tmp_path / "j"), f))
    t = _range_facade(keys, 4)
    t.delete(keys[::7])
    snapshot.save_snapshot(t, tmp_path / "t")
    theirs = jsnap.restore_store(tmp_path / "t", n_shards=2)
    for a, b in zip(t.items(), theirs.items()):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert jsnap.load_snapshot(tmp_path / "t").n_shards == 4
