"""The port's multi-rank waves (``serve_wave_sharded``, ``range_wave_sharded``
over ``torch.distributed``), the mesh helpers, ``launch/kv_dryrun.py`` and
the config registry, against the JAX package on the CPU.

One spawn of 2 ``gloo`` ranks and one of 4 (``launch.local_ranks``), each
with many waves inside, on a range facade before and during a live
rebalance; every gathered output is held against the JAX package's
``serve_wave_emulated`` / ``range_wave_emulated`` run in this process on
the same stacked pools, carried over by ``core/carry.py`` (the reference's
``test_shard_map_epoch_equivalence_forced_devices`` equates those with its
``shard_map`` waves), and bitwise against the port's own emulated waves.
GET rows are compared where found (B1's contract zeroes a not-found row,
the reference's plain ``get_batch`` leaves the probed slot).  A world-size-1
group runs in this process.  The spawned ranks import only the port."""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.core.lookup import InsertBuffers as JaxInsertBuffers
from repro.core.tree import DeviceTree as JaxDeviceTree
from repro.distributed import kvshard as jkv
from repro.distributed import rangeshard as jrs
from repro_torch.core import TreeConfig, carry, datasets
from repro_torch.core.keys import limbs_to_tensor, split_u64
from repro_torch.distributed import kvshard, rangeshard
from repro_torch.launch import kv_dryrun, mesh
from repro_torch.launch.local_ranks import WaveCase, spawn_waves

pytestmark = pytest.mark.timeout(300)

W = 8  # requests per rank


def limbs(qs):
    l = limbs_to_tensor(split_u64(qs), "cpu")
    return l[..., 0].contiguous(), l[..., 1].contiguous()


def jax_state(tree, ib):
    """The port's stacked pools as the JAX package's, through ``carry``."""
    return (JaxDeviceTree(**{k: jnp.asarray(v) for k, v in carry.tree_to_numpy(tree).items()}),
            JaxInsertBuffers(**{k: jnp.asarray(v) for k, v in carry.ib_to_numpy(ib).items()}))


def jax_wave(case: WaveCase, jtree, jib):
    """The JAX package's emulated wave for ``case``, jitted (one compile
    instead of an eager dispatch per op)."""
    return jax.jit(partial(_jax_wave, case))(jtree, jib)


def _jax_wave(case: WaveCase, jtree, jib):
    kh, kl = (jnp.asarray(x.numpy().view(np.uint32)) for x in (case.khi, case.klo))
    tag = None if case.epoch_tag is None else jnp.asarray(case.epoch_tag.numpy())
    if case.kind == "serve":
        route = lambda b: None if b is None else jrs.make_route_fn(b)  # noqa: E731
        return jkv.serve_wave_emulated(jtree, jib, kh, kl, **case.params, route_fn=route(case.boundaries),
                                       route_fn_prev=route(case.boundaries_prev), epoch_tag=tag)
    return jrs.range_wave_emulated(jtree, jib, kh, kl, case.boundaries, **case.params,
                                   boundaries_prev=case.boundaries_prev, epoch_tag=tag)


def assert_like_the_reference(got, want, ctx, serve: bool):
    """Port outputs (int32-held limbs, bools) == the reference's (u32,
    bools); GET values where found."""
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want), ctx
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == np.int32 and w.dtype == np.uint32:
            g = g.view(np.uint32)
        if serve and i in (0, 1):
            w = np.where(want[2], w, 0)
        np.testing.assert_array_equal(g, w, err_msg=f"{ctx} output {i}")


def _world(n_shards: int):
    """A range facade's stacked pools before a storm and during the live
    rebalance it opens (both boundary epochs live), requests and the cases
    of the reference's forced-devices test."""
    keys = datasets.sparse(1400, seed=73)
    st = kvshard.ShardedDPAStore(keys, keys ^ np.uint64(0xE), n_shards, TreeConfig(growth=16.0), partition="range",
                                 cache_cfg=None, device="cpu")
    old = st.stacked()
    b_old = st.boundaries.copy()
    storm = keys.max() + np.uint64(1) + np.arange(500, dtype=np.uint64) * np.uint64(3)
    st.put(storm, storm ^ np.uint64(0xE))
    st.flush()
    assert st.begin_rebalance(st.planner.propose(st.boundaries))
    new = st.stacked()
    b_new = st.boundaries.copy()
    assert old[2] == new[2]
    depth = new[2]
    rng = np.random.default_rng(n_shards)
    qs = np.concatenate([rng.choice(keys, n_shards * W // 2), rng.choice(storm, n_shards * W // 4),
                         rng.integers(0, 2**63, n_shards * W // 4, dtype=np.uint64)])
    rng.shuffle(qs)
    kh, kl = limbs(qs.reshape(n_shards, W))
    tag = torch.from_numpy((np.arange(n_shards * W).reshape(n_shards, W) % 2).astype(np.int32))
    g = dict(depth=depth, eps_inner=4, eps_leaf=8)
    r = dict(depth=depth, eps_inner=4)
    ample = n_shards * W
    cases = {
        "get hash": WaveCase("serve", kh, kl, dict(cap=ample, **g)),
        "get old epoch": WaveCase("serve", kh, kl, dict(cap=ample, **g), boundaries=b_old),
        "get new epoch": WaveCase("serve", kh, kl, dict(cap=ample, **g), boundaries=b_new, state=1),
        "get mixed epoch": WaveCase("serve", kh, kl, dict(cap=ample, **g), boundaries=b_new, boundaries_prev=b_old,
                                    epoch_tag=tag, state=1),
        "get retry": WaveCase("serve", kh, kl, dict(cap=2, **g), boundaries=b_new, state=1),
        "range old epoch": WaveCase("range", kh, kl, dict(cap=ample, limit=5, max_leaves=8, **r), boundaries=b_old),
        "range new epoch": WaveCase("range", kh, kl, dict(cap=ample, limit=5, max_leaves=8, **r), boundaries=b_new,
                                    state=1),
        "range mixed epoch": WaveCase("range", kh, kl, dict(cap=ample, limit=5, max_leaves=8, **r), boundaries=b_new,
                                      boundaries_prev=b_old, epoch_tag=tag, state=1),
        "range looped": WaveCase("range", kh, kl, dict(cap=ample, limit=40, max_leaves=1, **r), boundaries=b_new,
                                 state=1),
        "range retry": WaveCase("range", kh, kl, dict(cap=2, limit=5, max_leaves=8, fanout=2, **r),
                                boundaries=b_new, state=1),
        "range bounded": WaveCase("range", kh, kl, dict(cap=ample, limit=40, max_leaves=1, max_rounds=1, **r),
                                  boundaries=b_new, state=1),
    }
    return [old[:2], new[:2]], cases


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def ranks(request):
    """One spawn per world size: every case's gathered outputs, each rank's
    report, the JAX package's and the port's emulated outputs."""
    states, cases = _world(request.param)
    outs, reports = spawn_waves(states, list(cases.values()), device="cpu")
    jstates = [jax_state(*s) for s in states]
    return {
        "n": request.param,
        "cases": cases,
        "got": dict(zip(cases, outs)),
        "reports": reports,
        "jax": {n: jax_wave(c, *jstates[c.state]) for n, c in cases.items()},
        "port": {n: c.emulated(*states[c.state]) for n, c in cases.items()},
    }


def _check(ranks, names):
    for n in names:
        got = ranks["got"][n]
        assert_like_the_reference(got, ranks["jax"][n], (ranks["n"], n), serve=n.startswith("get"))
        for i, (a, b) in enumerate(zip(got, ranks["port"][n], strict=True)):
            assert a.dtype == b.dtype and torch.equal(a, b), (ranks["n"], n, i)


def test_sharded_get_waves_equal_the_reference(ranks):
    """Hash and range routing under each boundary epoch."""
    _check(ranks, ["get hash", "get old epoch", "get new epoch"])
    got = ranks["got"]
    assert all(bool(got[n][3].all()) for n in ("get hash", "get old epoch", "get new epoch"))
    assert bool(got["get new epoch"][2].any()) and not bool(got["get new epoch"][2].all())


def test_sharded_range_waves_equal_the_reference(ranks):
    """RANGE at ``limit=5, max_leaves=8`` under each epoch, all eight
    outputs, per-shard ``rounds`` included."""
    _check(ranks, ["range old epoch", "range new epoch"])
    for n in ("range old epoch", "range new epoch"):
        assert bool(ranks["got"][n][5].all()) and bool(ranks["got"][n][4].any())


def test_mixed_epoch_waves_equal_the_reference(ranks):
    """Mid-rebalance: each request routed by the epoch its tag carries,
    the tag on the wire beside the keys."""
    tag = ranks["cases"]["get mixed epoch"].epoch_tag
    assert 0 < int(tag.sum()) < tag.numel()
    _check(ranks, ["get mixed epoch", "range mixed epoch"])


def test_retry_rows_at_a_small_cap_equal_the_reference(ranks):
    _check(ranks, ["get retry", "range retry"])
    get_ok, range_ok = ranks["got"]["get retry"][3], ranks["got"]["range retry"][5]
    assert bool(get_ok.any()) and not bool(get_ok.all())
    assert not bool(range_ok.all())
    assert not bool(ranks["got"]["get retry"][2][~get_ok].any()), "a RETRY row carries an answer"


def test_looped_range_iterates_like_the_reference(ranks):
    """``limit=40, max_leaves=1``: several continuation rounds on some
    shard, per-shard ``rounds`` equal to the reference's, no truncation;
    ``max_rounds=1`` leaves truncated rows."""
    _check(ranks, ["range looped", "range bounded"])
    looped = ranks["got"]["range looped"]
    assert int(looped[7].max()) > 1 and not bool(looped[6].any())
    assert looped[7].shape == (ranks["n"],) and looped[7].dtype == torch.int32
    assert bool(ranks["got"]["range bounded"][6].any())


def test_every_rank_sends_the_same_exchanges(ranks):
    """Each rank issues the same collectives: 5 exchanges a GET wave (6
    with the epoch tag), 10 a RANGE wave, each of the whole ``(n, ...)``
    int32 tensor; every rank on a ``(n, 1)`` ``("data", "model")`` mesh at
    its own coordinate; CPU tensors never launch a kernel."""
    n = ranks["n"]
    for r, rep in enumerate(ranks["reports"]):
        assert rep["mesh"] == {"names": ["data", "model"], "shape": [n, 1], "data": [n, r]}
        assert rep["backend"] == "gloo" and rep["device"] == "cpu"
        assert not any(rep["launches"].values())
        for (name, case), wave in zip(ranks["cases"].items(), rep["waves"]):
            cap = case.params["cap"]
            if case.kind == "serve":
                calls = 5 + (case.epoch_tag is not None)
                assert (wave["exchanges"], wave["bytes"]) == (calls, calls * n * cap * 4), name
            else:
                limit = case.params["limit"]
                assert wave["exchanges"] == 10, name
                assert wave["bytes"] == (5 * n * cap + 5 * n * cap * limit) * 4, name


def _one_rank_group(tmp_path):
    import torch.distributed as dist

    mesh.init_process_group(0, 1, f"file://{tmp_path}/rendezvous", device="cpu")
    return dist


def test_waves_run_on_a_world_size_one_group(tmp_path):
    """The twin of the reference's one-device-mesh test, in this process: a
    1-shard range facade, both waves on a ``(1, 1)`` gloo mesh equal to the
    reference's emulated waves and to the facade's answers."""
    keys = datasets.sparse(1000, seed=5)
    st = kvshard.ShardedDPAStore(keys, keys ^ np.uint64(0x11), 1, partition="range", cache_cfg=None, device="cpu")
    tree, ib, depth = st.stacked()
    jtree, jib = jax_state(tree, ib)
    qs = np.sort(np.random.default_rng(1).choice(keys, 8)).reshape(1, 8)
    qs[0, -1] = np.uint64(2**63 + 5)  # not a key
    kh, kl = limbs(qs)
    dist = _one_rank_group(tmp_path)
    try:
        m = mesh.make_debug_mesh(device="cpu")
        assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 1)
        assert mesh.data_axis(m)[1:] == (1, 0)
        sub = kvshard.shard_state(tree, ib, 0)
        rfn = rangeshard.range_wave_sharded(m, tree, ib, st.boundaries, cap=8, depth=depth, eps_inner=4, limit=5,
                                            max_leaves=8)
        got_r = rfn(*sub, kh, kl)
        gfn = kvshard.serve_wave_sharded(m, tree, ib, cap=8, depth=depth, eps_inner=4, eps_leaf=8)
        got_g = gfn(*sub, kh, kl)
        with pytest.raises(TypeError, match="epoch_tag"):
            gfn(*sub, kh, kl, torch.ones((1, 8), dtype=torch.int32))
    finally:
        dist.destroy_process_group()
    assert (rfn.exchange.calls, gfn.exchange.calls) == (10, 5)
    want_r = jax_wave(WaveCase("range", kh, kl, dict(cap=8, depth=depth, eps_inner=4, limit=5, max_leaves=8),
                               boundaries=st.boundaries), jtree, jib)
    assert_like_the_reference(got_r, want_r, ("world 1", "range"), serve=False)
    want_g = jax_wave(WaveCase("serve", kh, kl, dict(cap=8, depth=depth, eps_inner=4, eps_leaf=8)), jtree, jib)
    assert_like_the_reference(got_g, want_g, ("world 1", "get"), serve=True)
    res = st.range(qs[0], 5, max_leaves=8)
    np.testing.assert_array_equal(got_r[4][0].numpy().sum(axis=1), res.counts)
    v, f = st.get(qs[0])
    np.testing.assert_array_equal(got_g[2][0].numpy(), f)
    assert f.sum() == 7 and bool(got_r[5].all()) and bool(got_g[3].all())


def test_mesh_helpers_follow_the_reference_shapes_and_refuse_a_silent_backend(tmp_path):
    """``production_mesh_shape`` holds the reference's shapes and axis
    names; a CPU mesh runs only on gloo; a mesh needs an initialised group
    of its size whose backend matches the device's rule."""
    assert mesh.production_mesh_shape() == ((16, 16), ("data", "model"))
    assert mesh.production_mesh_shape(multi_pod=True) == ((2, 16, 16), ("pod", "data", "model"))
    assert mesh.mesh_backend("cpu") == (torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="gloo"):
        mesh.mesh_backend("cpu", "nccl")
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_debug_mesh(device="cpu")
    dist = _one_rank_group(tmp_path)
    try:
        with pytest.raises(ValueError, match="ranks"):
            mesh.make_debug_mesh(2, 1, device="cpu")
        with pytest.raises(ValueError, match="ranks"):
            mesh.make_production_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_kv_dryrun_on_the_cpu(tmp_path):
    """Both meshes' records at a tiny key count: the reference's fields, the
    bytes of 5 exchanges of a ``(n_shards, cap)`` int32 tensor per device
    and wave, every answer checked against the shard's keys."""
    import json

    kv_dryrun.main(["--device", "cpu", "--n-keys", "20000", "--mesh", "both", "--out", str(tmp_path)])
    for name in ("pod16x16", "pod2x16x16"):
        rec = json.loads((tmp_path / f"dpastore-service__wave__{name}.json").read_text())
        for k in ("arch", "shape", "mesh", "supported", "status", "params_total", "params_active", "tokens",
                  "collective_bytes_per_device", "memory", "wave_ms"):
            assert k in rec, k
        assert rec["arch"] == "dpastore-service" and rec["mesh"] == name and rec["status"] == "ok"
        assert rec["n_shards"] == 16 and rec["cap"] == rec["wave_local"] == 65536 // 16
        assert rec["collective_bytes_per_device"] == 5 * rec["n_shards"] * rec["cap"] * 4 == 1310720
        assert rec["tokens"] == 65536 and rec["params_total"] == 20000 * 16
        assert rec["device"] == "cpu" and rec["memory"]["peak_bytes"] is None
        assert rec["found"] == rec["requests"] * 3 // 4
        assert "lower_s" not in rec and "compile_s" not in rec


@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS) + ["dpastore-service"])
def test_configs_equal_the_reference(name):
    """Every field of every config of the registry, and the registry's
    other names, equal to the JAX package's."""
    port, ref = tconfigs, jconfigs
    if name == "dpastore-service":
        a, b = port.dpastore_service, ref.dpastore_service
    else:
        assert sorted(port.ARCHS) == sorted(ref.ARCHS)
        a, b = port.ARCHS[name], ref.ARCHS[name]
        for s in ref.SHAPES:
            assert port.cell_supported(a, port.SHAPES[s]) == ref.cell_supported(b, ref.SHAPES[s]), s
        assert dataclasses.asdict(port.reduced(a)) == dataclasses.asdict(ref.reduced(b))
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert {k: dataclasses.asdict(v) for k, v in port.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.SHAPES.items()}
