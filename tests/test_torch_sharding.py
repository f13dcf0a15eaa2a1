"""Port ``distributed/sharding.py``, the bf16 accumulator and
``moe_bf16_combine`` == the JAX package's, on the CPU.

* Every spec (``param_specs``, ``opt_specs(zero=True)``, ``batch_spec``,
  ``cache_specs``) equals the reference's ``tuple(PartitionSpec)`` for the
  ten configs at full width on ``pod16x16``, ``pod2x16x16`` and a ``(2, 2)``
  debug shape.  The reference side runs ``jax.eval_shape`` and reads a mesh
  stand-in with ``shape`` and ``axis_names``; the port's, shapes on the
  meta device and a ``MeshShape``.  Nothing is compiled or allocated.
* ``to_placements`` round-trips, and its blocks are DTensor's.
* The bf16 accumulator: with a loss linear in the parameters (so both
  packages' microbatch gradients are the same bf16 numbers), the gradients
  the optimizer receives equal the reference's ``TrainConfig(accum_dtype=
  "bfloat16")`` step's bitwise, at reduced glm4 with 2 and 3 microbatches.
* ``moe_bf16_combine``: the reduced mixtral MoE layer's output equals the
  reference's bitwise with the flag on, and ``moe.combine`` at ``top_k=3``
  equals the reference's scatter-add bitwise (where one ``index_add_``
  does not).
* Each refused layout flag raises ``ValueError``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import reduced as jreduced
from repro.distributed import sharding as jshd
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.training import optimizer as joptimizer
from repro.training import train_step as jts
from repro_torch.configs import ARCHS, SHAPES, reduced
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.models import layers, lm, moe
from repro_torch.models.carry import from_numpy, to_numpy
from repro_torch.training import optimizer
from repro_torch.training import train_step as ts

MESHES = {
    "pod16x16": ((16, 16), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "debug2x2": ((2, 2), ("data", "model")),
}


@pytest.fixture(autouse=True)
def _no_flags():
    layers.set_perf_flags()
    yield
    layers.set_perf_flags()


class _JMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, sizes, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _jleaves(tree):
    return [tuple(p) for p in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))]


def _tleaves(tree):
    """A port spec tree's leaves in the reference's flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tleaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _tleaves(v)]
    return [tree]


def _meta_cache(cfg, shape):
    spec = lm.cache_spec(cfg, shape.global_batch, shape.seq_len)
    return {"slots": [{k: torch.empty(s, dtype=dt, device="meta") for k, (s, dt) in slot.items()}
                      for slot in spec["slots"]]}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_specs_equal_the_reference(name):
    """Parameters, optimizer state (ZeRO), batch and decode caches, on the
    three meshes, spec for spec."""
    jc, tc = JARCHS[name], ARCHS[name]
    jparams = jax.eval_shape(lambda: jlm.init(jc, jax.random.key(0)))
    tparams = lm.init(tc, torch.Generator(), device="meta")
    jopt = jax.eval_shape(lambda: joptimizer.init(joptimizer.OptConfig(kind=jc.optimizer), jparams))
    topt = optimizer.init(optimizer.OptConfig(kind=tc.optimizer), tparams)
    for mesh_name, (sizes, names) in MESHES.items():
        jm, tm = _JMesh(sizes, names), shd.MeshShape(names, sizes)
        jps, tps = jshd.param_specs(jc, jparams, jm), shd.param_specs(tc, tparams, tm)
        assert _tleaves(tps) == _jleaves(jps), (name, mesh_name, "params")
        jos = jshd.opt_specs(jc, jopt, jps, jm, zero=True)
        tos = shd.opt_specs(tc, topt, tps, tm, zero=True)
        assert sorted(tos) == sorted(jos)
        for k in jos:
            assert _tleaves(tos[k]) == _jleaves(jos[k]), (name, mesh_name, k)
        for shape_name in sorted(SHAPES):
            jb = jshd.batch_spec(jc, JSHAPES[shape_name], jm)
            tb = shd.batch_spec(tc, SHAPES[shape_name], tm)
            assert tb == {k: (None if v is None else tuple(v)) for k, v in jb.items()}
            if SHAPES[shape_name].kind != "decode":
                continue
            js = JSHAPES[shape_name]
            jcs = jshd.cache_specs(jc, js, jm, jlm.cache_spec(jc, js.global_batch, js.seq_len))
            tcs = shd.cache_specs(tc, SHAPES[shape_name], tm, _meta_cache(tc, SHAPES[shape_name]))
            assert _tleaves(tcs) == _jleaves(jcs), (name, mesh_name, shape_name)


def test_mesh_shape_reads_the_reference_meshes():
    from repro_torch.launch.mesh import production_mesh_shape

    assert shd.mesh_shape(production_mesh_shape()) == shd.MeshShape(("data", "model"), (16, 16))
    ms = shd.mesh_shape(production_mesh_shape(multi_pod=True))
    assert ms.size("pod") == 2 and ms.size("data") == 16 and ms.size("expert") == 1
    assert shd.batch_axes(ms) == ("pod", "data") and shd.batch_axes(MESHES["debug2x2"]) == ("data",)
    assert shd.P(("data",), None) == tuple(JP(("data",), None)) == ("data", None)
    assert shd.P((), ["pod", "data"]) == tuple(JP((), ("pod", "data")))


@pytest.mark.parametrize("mesh_name", ["pod2x16x16", "debug2x2"])
def test_to_placements_round_trips_in_dtensor_order(mesh_name):
    """``from_placements(to_placements(spec)) == spec`` for every spec of a
    dense, an MoE and a hybrid config; ``shard_slices`` gives the block
    DTensor computes for a rank's coordinate (the reference's row-major
    split of a dim over ``("pod", "data")``); axes out of the mesh's order
    are refused."""
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    sizes, names = MESHES[mesh_name]
    with dryrun.fake_mesh(sizes, names) as mesh:
        for name in ("glm4-9b", "mixtral-8x7b", "jamba-1.5-large-398b"):
            cfg = ARCHS[name]
            params = lm.init(cfg, torch.Generator(), device="meta")
            specs = _tleaves(shd.param_specs(cfg, params, mesh)) + list(
                shd.batch_spec(cfg, SHAPES["train_4k"], mesh).values())
            shapes = [tuple(p.shape) for p in _tleaves(params)]
            for sp in specs:
                if sp is not None:
                    assert shd.from_placements(shd.to_placements(sp, mesh), len(sp), mesh) == sp
            for sp, shape in zip(specs, shapes):
                lay = shd.Layout(mesh, shd.to_placements(sp, mesh))
                for coords in ([0] * len(sizes), [s - 1 for s in sizes], [1] * len(sizes)):
                    want_shape, offset = _compute_local_shape_and_global_offset(shape, sizes, coords, lay.placements)
                    got = shd.shard_slices(shape, lay, coords)
                    assert tuple(s.start for s in got) == tuple(offset)
                    assert tuple(s.stop - s.start for s in got) == tuple(want_shape)
        tok = shd.to_placements(shd.P(shd.batch_axes(mesh), None), mesh)
        assert [p.is_shard() for p in tok] == [n != "model" for n in names]
        if "pod" in names:
            with pytest.raises(ValueError, match="order"):
                shd.to_placements((("data", "pod"), None), mesh)
        with pytest.raises(ValueError, match="two dims"):
            shd.to_placements(("model", "model"), mesh)


# ---------------------------------------------------------------- bf16 accumulator


def _linear_loss_pair(coeffs):
    """Loss functions of both packages that are linear in the parameters:
    ``sum_leaf sum(p_f32 * C_leaf * s)``, ``s`` the microbatch's first
    label plus one, so every microbatch gradient is ``bf16(C * s)`` in both."""

    def jloss(cfg, params, mb):
        s = mb["labels"][0, 0].astype(jnp.float32) + 1.0
        total = sum(jnp.sum(p.astype(jnp.float32) * (jnp.asarray(c) * s))
                    for p, c in zip(jax.tree.leaves(params), coeffs))
        return total, {"ce": total, "aux": jnp.float32(0.0)}

    def tloss(cfg, params, mb):
        from repro_torch.checkpoint.manager import tree_flatten

        s = mb["labels"][0, 0].float() + 1.0
        total = sum(torch.sum(p.float() * (torch.from_numpy(c) * s)) for p, c in zip(tree_flatten(params)[0], coeffs))
        return total, {"ce": total, "aux": torch.zeros(())}

    return jloss, tloss


@pytest.mark.parametrize("microbatches", [2, 3])
def test_bf16_accumulator_equals_the_reference_bitwise(microbatches, monkeypatch):
    """The gradients ``optimizer.update`` receives from a bf16-accumulated
    step: each microbatch's bf16 gradient added as ``a + g.to(bf16)`` and
    the sum divided by the count once, as the reference does, bit for
    bit; then the step runs on (its loss from its accumulator)."""
    jc, tc = jreduced(JARCHS["glm4-9b"]), reduced(ARCHS["glm4-9b"])
    jc, tc = dataclasses.replace(jc, n_layers=jc.superblock), dataclasses.replace(tc, n_layers=tc.superblock)
    jt = jts.TrainConfig(opt=joptimizer.OptConfig(lr=1e-3), microbatches=microbatches, accum_dtype="bfloat16")
    tt = ts.TrainConfig(opt=optimizer.OptConfig(lr=1e-3), microbatches=microbatches, accum_dtype="bfloat16")
    jstate = jts.init_state(jc, jt, jax.random.key(1))
    state = from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    rng = np.random.default_rng(7)
    coeffs = [(rng.normal(size=np.shape(p)) * np.exp2(rng.integers(-8, 8, size=np.shape(p)))).astype(np.float32)
              for p in jax.tree.leaves(jstate["params"])]
    labels = np.repeat(np.arange(microbatches, dtype=np.int32), 2)[:, None] * np.ones((1, 8), np.int32)
    jloss, tloss = _linear_loss_pair(coeffs)
    got = {}
    monkeypatch.setattr(jlm, "loss_fn", jloss)
    monkeypatch.setattr(lm, "loss_fn", tloss)
    for mod, key in ((joptimizer, "jax"), (optimizer, "torch")):
        orig = mod.update
        monkeypatch.setattr(mod, "update", lambda c, p, g, s, orig=orig, key=key: (got.__setitem__(key, g),
                                                                                  orig(c, p, g, s))[1])
    with jax.disable_jit():
        jts.make_train_step(jc, jt)(jstate, {"tokens": jnp.asarray(labels), "embeds": None,
                                             "labels": jnp.asarray(labels)})
    ts.make_train_step(tc, tt)(state, {"tokens": torch.from_numpy(labels), "embeds": None,
                                       "labels": torch.from_numpy(labels)})
    from repro_torch.checkpoint.manager import tree_flatten

    jg, tg = jax.tree.leaves(got["jax"]), tree_flatten(got["torch"])[0]
    assert len(jg) == len(tg)
    for a, b in zip(jg, tg):
        assert str(a.dtype) == "bfloat16" and b.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(a, np.float32), to_numpy(b))
    # the accumulation rounds: an f32 accumulator gives other numbers
    assert any(not np.array_equal(np.asarray(a, np.float32),
                                  (np.asarray(c, np.float32) * sum(i + 1 for i in range(microbatches))
                                   / microbatches).astype(jnp.bfloat16).astype(np.float32))
               for a, c in zip(jg, coeffs))


# ---------------------------------------------------------------- moe_bf16_combine


def test_moe_bf16_combine_layer_equals_the_reference_bitwise():
    """Reduced mixtral's MoE layer (its init, 2 x 32 tokens): the output
    with ``combine_dtype=bf16`` (what the flag passes) equals the
    reference's bit for bit, and through ``lm`` the flag reaches it."""
    jc = jreduced(JARCHS["mixtral-8x7b"])
    tc = reduced(ARCHS["mixtral-8x7b"])
    jparams = jlm.init(jc, jax.random.key(2))
    jp = jmoe.MoEParams(**jax.tree.map(lambda a: a[0], jparams["blocks"][0]["moe"]))
    tp = moe.MoEParams(**from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu"))
    x = np.random.default_rng(0).normal(size=(2, 32, tc.d_model))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = from_numpy(np.asarray(jx), "cpu")
    with jax.disable_jit():
        want, jaux = jmoe.apply(jp, jx, top_k=jc.experts_per_token, capacity_factor=jc.capacity_factor,
                                combine_dtype=jnp.bfloat16)
    got, taux = moe.apply(tp, tx, top_k=tc.experts_per_token, capacity_factor=tc.capacity_factor,
                          combine_dtype=torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(want, np.float32), to_numpy(got))
    assert float(jaux) == float(taux)
    seen = []
    orig = moe.combine
    moe.combine = lambda *a: (seen.append(a[-1]), orig(*a))[1]
    try:
        layers.set_perf_flags(moe_bf16_combine=True)
        with torch.no_grad():
            lm.forward(tc, lm.init(tc, 0, device="cpu"), tokens=torch.zeros((1, 8), dtype=torch.int32))
    finally:
        moe.combine = orig
    assert seen and all(d == torch.bfloat16 for d in seen)


def test_bf16_combine_at_top3_equals_the_reference_scatter_bitwise():
    """``moe.combine`` in bf16 with three entries a token (and dropped
    ones) in a shuffled dispatch order, rows of magnitudes 2^-12..2^12:
    equal to the reference's ``.at[tok].add(mode="drop")`` bit for bit;
    one bf16 ``index_add_`` (f32 sum, one rounding) is not."""
    rng = np.random.default_rng(0)
    T, D, k = 16, 32, 3
    tgt = np.repeat(np.arange(T), k)
    rng.shuffle(tgt)
    tgt[:4] = T  # dropped
    rows = (rng.normal(size=(T * k, D)) * np.exp2(rng.integers(-12, 12, size=(T * k, 1)))).astype(np.float32)
    jrows = jnp.asarray(rows).astype(jnp.bfloat16)
    with jax.disable_jit():
        want = np.asarray(jnp.zeros((T, D), jnp.bfloat16).at[jnp.asarray(tgt)].add(jrows, mode="drop"), np.float32)
    trows = from_numpy(np.asarray(jrows), "cpu")
    got = moe.combine(trows, torch.from_numpy(tgt), T, k, torch.bfloat16)
    np.testing.assert_array_equal(want, to_numpy(got))
    once = torch.zeros((T + 1, D), dtype=torch.bfloat16).index_add_(0, torch.from_numpy(tgt), trows)[:T]
    assert not np.array_equal(want, to_numpy(once))
    f32 = moe.combine(trows, torch.from_numpy(tgt), T, k)
    assert f32.dtype == torch.float32


# ---------------------------------------------------------------- refused flags


@pytest.mark.parametrize("name", list(layers.LAYOUT_FLAGS))
def test_layout_flags_are_refused_by_design(name):
    """The reference's GSPMD layout hints raise ``ValueError`` naming the
    flag and why; the flags stay as they were."""
    layers.set_perf_flags(moe_bf16_combine=True)
    with pytest.raises(ValueError, match=name) as e:
        layers.set_perf_flags(**{name: object()})
    assert "tensor-parallel" in str(e.value)
    assert layers.PERF_FLAGS == {"moe_bf16_combine": True}


@pytest.mark.parametrize("name", list(dryrun.GSPMD_FLAGS))
def test_dryrun_refuses_the_gspmd_perf_names(name):
    with pytest.raises(ValueError, match=name):
        dryrun.perf_flags(("paired_causal", name))
    assert dryrun.perf_flags(("paired_causal", "block_kv=256", "moe_bf16_combine")) == {
        "paired_causal": True, "block_kv": 256, "moe_bf16_combine": True}
