"""Boundaries of the port: it never imports JAX or the JAX package, it never
falls back to the CPU unasked, and — on a machine with a card — each CUDA
kernel equals its plain-torch version bitwise (skipped without CUDA).  This
file imports no JAX, so its card tests run on a machine without it."""

import ast
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 4
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_designs.py"] + examples
    assert len(files) > 10
    for f in files:
        bad = {m for m in _imported_roots(f) if m in ("jax", "jaxlib", "repro")}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.kernels.ops, "
        "repro_torch.core.carry, repro_torch.core.datasets, repro_torch.core.perfmodel, "
        "repro_torch.serving.engine, repro_torch.serving.pipeline, repro_torch.serving.admission, "
        "repro_torch.launch.serve, repro_torch.distributed.kvshard, repro_torch.distributed.rangeshard, "
        "repro_torch.distributed.snapshot, repro_torch.distributed.elastic, repro_torch.checkpoint.manager, "
        "repro_torch.launch.mesh, repro_torch.launch.kv_dryrun, repro_torch.launch.local_ranks, repro_torch.configs, "
        "repro_torch.distributed.sharding, repro_torch.launch.dryrun, "
        "repro_torch.models.layers, repro_torch.models.moe, repro_torch.models.mamba, repro_torch.models.lm, "
        "repro_torch.models.carry, repro_torch.device, repro_torch.data.pipeline, repro_torch.training.optimizer, "
        "repro_torch.training.compress, repro_torch.training.train_step, repro_torch.launch.train, "
        "repro_torch.core.btree, repro_torch.core.rolex_model, runpy; "
        "[runpy.run_path(f'examples/torch_{n}.py') for n in ('kv_serve', 'quickstart', 'paged_decode', 'train_lm')]; "
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules, sorted(sys.modules)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT)


def test_core_does_not_import_the_serving_layer():
    code = (
        "import sys, repro_torch.core, repro_torch.core.carry, repro_torch.kernels.ops; "
        "assert not any(m.startswith('repro_torch.serving') for m in sys.modules), sorted(sys.modules)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT)


def test_gather_kernel_wrapper_refuses_cpu_tensors():
    """``gather_cuda`` launches the kernel or raises: a CPU pool never
    reaches the plain version through it."""
    from repro_torch.kernels import paged_gather

    pool = torch.zeros((4, 2, 2, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        paged_gather.gather_cuda(pool, torch.tensor([1, 2], dtype=torch.int32))


def test_probe_kernel_wrapper_refuses_cpu_tensors():
    """``probe_cuda`` launches the kernel or raises: CPU caches never reach
    the plain version through it."""
    from repro_torch.core import hotcache
    from repro_torch.kernels import cache_probe

    cfg = hotcache.CacheConfig(n_threads=4)
    c = hotcache.make_cache(cfg, "cpu")
    khi = klo = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cache_probe.probe_cuda(c.bloom, c.bkey, c.bval, c.bvalid, khi, khi, klo, bloom_bits=cfg.bloom_bits,
                               n_buckets=cfg.n_buckets, salts_bloom=hotcache.SALT_BLOOM,
                               salt_bucket=hotcache.SALT_BUCKET)


def test_store_defaults_to_the_card():
    from repro_torch.core import DPAStore

    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    keys = np.arange(1, 200, dtype=np.uint64) * np.uint64(7919)
    with pytest.raises(RuntimeError, match="CUDA"):
        DPAStore(keys, keys)
    with pytest.raises(RuntimeError, match="CUDA"):
        DPAStore(keys, keys, device="cuda")


def test_mesh_and_dry_run_default_to_the_card(tmp_path):
    """``make_debug_mesh()`` and ``kv_dryrun.run`` without a device mean the
    card: without CUDA they raise before touching a process group or
    loading a key."""
    from repro_torch.launch import kv_dryrun, mesh

    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_debug_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        kv_dryrun.run(False, tmp_path)
    assert not any(tmp_path.iterdir())


def test_lm_defaults_to_the_card():
    """``lm.init``, ``lm.init_cache``, ``Engine`` and the launcher's LM mode
    without a device mean the card: without CUDA they raise."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    cfg = dataclasses.replace(reduced(ARCHS["glm4-9b"]), n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_cache(cfg, 1, 8)
    params = lm.init(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "glm4-9b", "--reduced", "--steps", "1"])


def test_training_defaults_to_the_card(tmp_path):
    """``init_state`` (the train step's state), a restore and the training
    launcher without a device mean the card: without CUDA they raise."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import train
    from repro_torch.training import train_step as ts

    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    cfg = reduced(ARCHS["glm4-9b"])
    tcfg = ts.TrainConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.init_state(cfg, tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.init_state(cfg, tcfg, device="cuda")
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, ts.init_state(cfg, tcfg, device="cpu"), blocking=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.restore(mgr, 1, cfg, tcfg, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--batch", "2", "--seq", "16", "--steps", "1"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_equal_plain_versions_on_the_card(cuda_device):
    from repro_torch.core import DPAStore, datasets, hotcache, lookup
    from repro_torch.kernels import cache_probe, range_scan, traverse

    keys = datasets.sparse(20000, seed=1)
    st = DPAStore(keys, keys ^ np.uint64(0x5A5A), device=cuda_device)
    rng = np.random.default_rng(2)
    st.put(rng.integers(0, 2**63, 3000, dtype=np.uint64), rng.integers(0, 2**64, 3000, dtype=np.uint64))
    st.delete(keys[:500])
    q = np.concatenate([rng.choice(keys, 3000), rng.integers(0, 2**64, 1000, dtype=np.uint64)])
    st.get(q)
    st.get(q)
    st.range(q[:500], limit=16)
    khi, klo = st._limbs(q)
    kw = dict(depth=st.depth, eps_inner=st.cfg.eps_inner, eps_leaf=st.cfg.eps_leaf)
    for a, b in zip(traverse.get_cuda(st.tree, st.ib, khi, klo, **kw),
                    traverse.get_plain(st.tree, st.ib, khi, klo, **kw)):
        assert torch.equal(a, b)
    tid = hotcache.steer(khi, klo, st.cache_cfg.n_threads)
    c = st.cache
    pk = dict(bloom_bits=st.cache_cfg.bloom_bits, n_buckets=st.cache_cfg.n_buckets,
              salts_bloom=hotcache.SALT_BLOOM, salt_bucket=hotcache.SALT_BUCKET)
    a = cache_probe.probe_cuda(c.bloom, c.bkey, c.bval, c.bvalid, tid, khi, klo, **pk)
    b = cache_probe.probe_plain(c.bloom, c.bkey, c.bval, c.bvalid, tid, khi, klo, **pk)
    assert bool(a[0].any()) and all(torch.equal(x, y) for x, y in zip(a, b))
    start = lookup.traverse(st.tree, khi, klo, depth=st.depth, eps_inner=st.cfg.eps_inner)
    start = torch.where(torch.arange(q.size, device=cuda_device) % 7 == 0, -1, start)  # dead lanes
    for a, b in zip(range_scan.walk_cuda(st.tree, start, khi, klo, limit=74, max_leaves=4),
                    range_scan.walk_plain(st.tree, start, khi, klo, limit=74, max_leaves=4)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_gather_kernel_equals_plain_version_on_the_card(cuda_device):
    """Kernel B4 == its plain version bitwise: a bf16 pool at the llama3-405b
    layer's block (16 x 8 x 128) and an f32 pool (16-byte words), a bf16
    block of 3 x 5 x 7 = 210 bytes (not a multiple of 16: 2-byte words),
    each with random slots, the out-of-range edge slots and an empty list."""
    from repro_torch.kernels import paged_gather

    gen = torch.Generator().manual_seed(6)
    for shape, dtype in (
        ((64, 16, 8, 128), torch.bfloat16),
        ((64, 4, 2, 8), torch.float32),
        ((33, 3, 5, 7), torch.bfloat16),
    ):
        pool = torch.randn(shape, generator=gen).to(dtype).to(cuda_device)
        N = shape[0]
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        for idx in (
            torch.randint(0, N, (100,), generator=gen),
            torch.tensor([-1, N, N + 3, -N - 1, 2**31 - 1, -(2**31), 0, N - 1]),
            torch.zeros(0),
        ):
            slots = idx.to(torch.int32).to(cuda_device)
            got = paged_gather.gather(pool, slots)
            want = paged_gather.gather_plain(pool, slots)
            torch.cuda.synchronize()
            assert got.shape == want.shape == (idx.numel(), *shape[1:]) and got.dtype == dtype
            assert torch.equal(got.view(bits), want.view(bits))
        assert paged_gather.gather_cuda(pool, slots[:0]).shape == (0, *shape[1:])


_DATASETS = ["sparse", "sparseBig", "dense4x", "wiki", "amzn", "osmc", "face"]
# (keys, eps, ib_cap): a depth-2 tree; a deeper one (osmc reaches depth 4);
# the page table's ib_cap 32; wide windows (more than one pass of lanes);
# and far queries, whose leaf predictions pass 2^31 on osmc
_GET_SHAPES = {
    "small": (3000, (4, 8), 16),
    "deep": (30000, (1, 2), 16),
    "ib32": (20000, (4, 8), 32),
    "wide": (3000, (16, 16), 16),
    "far": (3000, (16, 16), 16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(_GET_SHAPES))
@pytest.mark.parametrize("dataset", _DATASETS)
def test_get_kernel_equals_plain_on_every_dataset(cuda_device, dataset, shape):
    """Kernel B1 == ``get_plain`` bitwise on a churned tree (buffered PUTs of
    new and existing keys and DELETEs left in the insert buffers), at every
    depth the trees reach here and at depth 1 (the root set to a leaf), for
    1-request and 300-request waves (a warp per request), and waves of 40000
    and 300000 requests (a thread per request)."""
    from repro_torch.core import DPAStore, TreeConfig, datasets
    from repro_torch.kernels import build, traverse

    n, eps, cap = _GET_SHAPES[shape]
    keys = datasets.DATASETS[dataset](n, seed=3 if shape == "far" else 11)
    st = DPAStore(keys, keys ^ np.uint64(0x5A5A), TreeConfig(eps_inner=eps[0], eps_leaf=eps[1], ib_cap=cap,
                                                            growth=20.0), cache_cfg=None, device=cuda_device)
    rng = np.random.default_rng(5)
    newk = rng.integers(0, 2**63, 400, dtype=np.uint64)
    st.put(newk, newk + np.uint64(77))
    st.put(keys[::9], keys[::9] + np.uint64(1))
    st.delete(np.concatenate([keys[::13], newk[::5]]))
    if shape == "far":
        q = rng.integers(0, 2**64, 512, dtype=np.uint64)
    else:
        q = np.concatenate([rng.choice(keys, 24000), rng.choice(newk, 4000),
                            rng.integers(0, 2**64, 12000, dtype=np.uint64)])
    if shape == "deep" and dataset == "osmc":
        assert st.depth == 4
    if shape == "far" and dataset == "osmc":  # the saturating float->int32 cast is exercised
        from repro_torch.core import lookup
        from repro_torch.core.keys import u32

        kh, kl = st._limbs(q)
        leaf = lookup.traverse(st.tree, kh, kl, depth=st.depth, eps_inner=eps[0]).long()
        a = u32(st.tree.leaf_anchor[leaf])
        assert bool((lookup._predict(st.tree.leaf_slope[leaf], a[:, 0], a[:, 1], u32(kh), u32(kl)) >= 2.0**31).any())
    ib_used = int((st.ib.count > 0).sum())
    assert ib_used > 0, "no buffered writes left in the insert buffers"
    eps_kw = dict(eps_inner=eps[0], eps_leaf=eps[1])
    leaf0 = st.tree.root.new_tensor(st.image.first_leaf())
    big = 300_000
    for tree, depth in ((st.tree, st.depth), (st.tree._replace(root=leaf0), 1)):
        for wave in (q[:1], q[:300], q, np.resize(q, big)):
            khi, klo = st._limbs(wave)
            got = traverse.get_cuda(tree, st.ib, khi, klo, depth=depth, **eps_kw)
            want = traverse.get_plain(tree, st.ib, khi, klo, depth=depth, **eps_kw)
            torch.cuda.synchronize()
            for a, b, name in zip(got, want, ("vhi", "vlo", "found")):
                assert torch.equal(a, b), f"{name}: depth {depth}, {wave.size} requests"
            assert shape == "far" or depth == 1 or wave.size == 1 or bool(got[2].any()), "no request found"
    sm = build.sm_count(cuda_device.index or 0)
    plans = [traverse.get_plan(m, *eps, sm, traverse._ctas_per_sm).warp for m in (1, 300, q.size, big)]
    assert plans == [True, True, q.size < 1000, False], plans  # both kernels ran


@pytest.mark.cuda
@pytest.mark.parametrize("n", [59, 1000])
@pytest.mark.parametrize(
    "block,dtype,offset",
    [((16, 8, 128), torch.bfloat16, 0), ((16, 8, 128), torch.bfloat16, 4), ((3, 5, 7), torch.bfloat16, 0),
     ((4, 2, 8), torch.float32, 0)],
)
def test_gather_kv_kernel_equals_plain_on_the_card(cuda_device, block, dtype, offset, n):
    """Kernel B4 on one pool and on a K and V pair == the plain versions
    bitwise: 32 KiB bf16 blocks (the bulk path, and pools 8 bytes off a
    16-byte boundary, the word path), 210-byte bf16 blocks (2-byte words)
    and 256-byte f32 blocks, with slot lists shorter and longer than the
    SM count, random slots and the out-of-range edge slots."""
    from repro_torch.kernels import build, paged_gather

    N = 1100
    gen = torch.Generator().manual_seed(7)
    size = N * int(np.prod(block))
    pools = [torch.randn(size + offset, generator=gen).to(dtype).to(cuda_device)[offset:].view(N, *block)
             for _ in range(2)]
    idx = torch.randint(0, N, (n,), generator=gen)
    idx[:6] = torch.tensor([-1, N, N + 3, -N - 1, 2**31 - 1, -(2**31)])
    slots = idx.to(torch.int32).to(cuda_device)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    before = build.launches["paged_gather"]
    got = [paged_gather.gather_cuda(pools[0], slots), *paged_gather.gather_kv_cuda(*pools, slots)]
    want = [paged_gather.gather_plain(pools[0], slots), *paged_gather.gather_kv_plain(*pools, slots)]
    torch.cuda.synchronize()
    assert build.launches["paged_gather"] == before + 2  # the pair is one launch
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape == (n, *block) and a.dtype == dtype
        assert torch.equal(a.view(bits), b.view(bits))


def _probe_state(fill, T, NB, W, P, bits, offset, device):
    """A cache state filled by hand (no admits): ``empty``, ``random`` (about
    half the ways valid; some keys twice in their bucket with different
    payloads; most keys' Bloom bits set, so that some sit in their bucket
    Bloom-negative) or ``full`` (every way valid).  ``offset``: the key,
    payload and flag arrays start one element past an aligned base.  Returns
    the arrays and 65536 probe keys (cached keys and random ones)."""
    from repro_torch.core import cacheset, hotcache
    from repro_torch.core.keys import u32

    rng = np.random.default_rng(T * 1000 + NB * 10 + W + P)
    n = T * NB * W
    bloom = np.zeros((T, bits // 32), np.uint32)
    bkey = rng.integers(0, 2**32, (T, NB, W, 2), dtype=np.uint32)
    bpay = rng.integers(0, 2**32, (T, NB, W, P), dtype=np.uint32)
    bvalid = np.zeros((T, NB, W), bool) if fill == "empty" else (
        np.ones((T, NB, W), bool) if fill == "full" else rng.random((T, NB, W)) < 0.5)
    keys = rng.integers(0, 2**64, n, dtype=np.uint64)

    def limbs(k):
        return [torch.from_numpy(x.astype(np.uint32).view(np.int32).copy())
                for x in (k >> np.uint64(32), k & np.uint64(2**32 - 1))]

    if fill != "empty":
        kh, kl = limbs(keys)
        t = hotcache.steer(kh, kl, T).numpy()
        b = cacheset.bucket_of(u32(kh), u32(kl), NB, hotcache.SALT_BUCKET).numpy()
        way = rng.integers(0, W, n)
        twice = rng.random(n) < 0.3
        for ws in (way, np.where(twice, (way + 1 + rng.integers(0, W, n)) % W, way)):
            bkey[t, b, ws, 0] = (keys >> np.uint64(32)).astype(np.uint32)
            bkey[t, b, ws, 1] = (keys & np.uint64(2**32 - 1)).astype(np.uint32)
        marked = rng.random(n) < 0.8
        for h in cacheset.bloom_hashes(u32(kh), u32(kl), bits, hotcache.SALT_BLOOM):
            h = h.numpy()[marked]
            np.bitwise_or.at(bloom, (t[marked], h // 32), np.uint32(1) << (h % 32).astype(np.uint32))
    probes = np.concatenate([rng.choice(keys, 45000), rng.integers(0, 2**64, 65536 - 45000, dtype=np.uint64)])

    def put(a, dtype):
        flat = torch.from_numpy(a.view(dtype).reshape(-1).copy())
        pad = torch.zeros(flat.numel() + offset, dtype=flat.dtype)
        pad[offset:] = flat
        return pad.to(device)[offset:].view(a.shape)

    return ((put(bloom, np.int32), put(bkey, np.int32), put(bpay, np.int32), put(bvalid, np.bool_)),
            [t.to(device) for t in limbs(probes)])


@pytest.mark.cuda
@pytest.mark.parametrize("n_buckets", [8, 24])
@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("W", [2, 4, 8])
def test_probe_kernel_equals_plain_in_every_shape(cuda_device, W, P, n_buckets):
    """Kernel B2 in every shape that takes the layout (and CTAs of 128 and
    256) == ``probe_plain`` bitwise, on an empty cache, a half-filled one
    with repeated keys and Bloom-negative keys in their buckets, and full
    buckets; at aligned bases and one element off them (the vector shapes
    refuse those, and the plan takes the generic one); for waves of 0, 1,
    300 and 65536 requests.  ``probe_cuda`` launches once per non-empty wave
    in the plan's shape."""
    from repro_torch.core import hotcache
    from repro_torch.kernels import build, cache_probe

    T, bits = 64, 256
    kw = dict(bloom_bits=bits, n_buckets=n_buckets, salts_bloom=hotcache.SALT_BLOOM,
              salt_bucket=hotcache.SALT_BUCKET)
    for fill in ("empty", "random", "full"):
        for offset in (0, 1):
            (bloom, bkey, bpay, bvalid), (khi, klo) = _probe_state(fill, T, n_buckets, W, P, bits, offset,
                                                                   cuda_device)
            aligned = cache_probe.vector_aligned(bkey, bpay, bvalid)
            assert aligned == (offset == 0)
            for B in (0, 1, 300, 65536):
                tid = hotcache.steer(khi[:B], klo[:B], T)
                args = (bloom, bkey, bpay, bvalid, tid, khi[:B], klo[:B])
                want = cache_probe.probe_plain(*args, **kw)
                if fill == "random" and B == 65536:
                    assert bool(want[0].any()) and not bool(want[0].all())
                for design, threads in itertools.product(cache_probe.DESIGNS, (128, 256)):
                    plan = cache_probe.shape(design, B, threads)
                    if not cache_probe.serves(design, W, P, aligned):
                        with pytest.raises(ValueError, match="shape does not take"):
                            cache_probe.launch(*args, plan=plan, **kw)
                        continue
                    got = cache_probe.launch(*args, plan=plan, **kw)
                    torch.cuda.synchronize()
                    for a, b, name in zip(got, want, ("hit", "payload"), strict=True):
                        assert a.shape == b.shape and a.dtype == b.dtype
                        assert torch.equal(a, b), f"{name}: {plan}, {fill}, offset {offset}, B={B}"
                name = f"cache_probe_p{P}"
                before = build.launches.get(name, 0)
                got = cache_probe.probe_cuda(*args, **kw)
                torch.cuda.synchronize()
                assert build.launches.get(name, 0) == before + (B > 0)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
    sm = build.sm_count(cuda_device.index or 0)  # both shapes the plan picks ran above
    assert [cache_probe.probe_plan(B, 4, 2, True, sm).design for B in (300, 65536)] == ["vector", "lean"]


@pytest.mark.cuda
def test_card_equals_cpu_on_a_versioned_ttl_stream(cuda_device):
    """Point-in-time reads, TTL expiry, the sweep and the write fast path on
    the card == on the CPU: every answer, ``items()`` and every counter."""
    import dataclasses

    from repro_torch.core import DPAStore, TreeConfig, datasets

    keys = datasets.sparse(3000, seed=2)
    keys[::2] |= np.uint64(0xFFFFFFFF)  # leaves ending on a low limb of all ones
    keys = np.unique(keys)
    stores = [DPAStore(keys, keys ^ np.uint64(0x77), TreeConfig(growth=64.0), retain_epochs=40, device=d)
              for d in (cuda_device, "cpu")]
    out = [[] for _ in stores]
    for i, s in enumerate(stores):
        r = np.random.default_rng(5)
        ttl_keys = r.choice(keys, 300, replace=False)
        s.put(ttl_keys, ttl_keys ^ np.uint64(3), ttl=2)
        e0 = s.snapshot_epoch()
        s.put(keys[::4], keys[::4] ^ np.uint64(9))
        s.delete(keys[1::9])
        w = s.write_issue("put", keys[2:6], keys[2:6])
        out[i].append(None if w is None else s.write_finalize(w))
        s.ttl.tick(2)
        q = r.choice(keys, 500)
        out[i] += [*s.get(q), *s.get(q, as_of=e0)]
        for as_of in (None, e0):
            res = s.range(q[:200], limit=12, as_of=as_of)
            out[i] += [res.keys, res.vals, res.counts]
        out[i].append(np.array([s.ttl_sweep()]))
        res = s.range_with_state(q[:64], limit=40, max_leaves=1, max_rounds=1, as_of=e0)
        out[i] += [res.keys, res.counts, res.cursor_leaf, res.cursor_key]
        out[i] += [*s.items()]
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(stores[0].stats) == dataclasses.asdict(stores[1].stats)


@pytest.mark.cuda
def test_pipelined_equals_serial_on_the_card(cuda_device):
    """``PipelinedStore`` at depths 2 and 4 over a store on the card ==
    the same store run serially, with tickets redeemed only at the end
    (every flush lands between in-flight waves): each output, ``items()``
    and every counter but the ledger's times."""
    import dataclasses

    from repro_torch.core import DPAStore, TreeConfig
    from repro_torch.serving.pipeline import PipelinedStore

    rng = np.random.default_rng(12)
    keys = np.unique(rng.integers(1, 2**63, 400, dtype=np.uint64))
    script = []
    for i in range(24):
        q = rng.integers(1, 2**63, 24, dtype=np.uint64)
        kind = ("get", "put", "range", "delete", "put", "flush")[i % 6]
        script.append((kind, np.unique(q) if kind in ("put", "delete") else q, int(rng.choice([1, 7, 40]))))
    script.append(("put", np.arange(keys[200] + 1, keys[200] + 41, dtype=np.uint64), 0))  # fills buffers: serial
    for qd in (2, 4):
        serial, piped = (DPAStore(keys, keys ^ np.uint64(0xD1FF), TreeConfig(growth=16.0), device=cuda_device)
                         for _ in range(2))
        pipe = PipelinedStore(piped, queue_depth=qd)
        want, got = [], [None] * len(script)
        tickets = []
        for i, (kind, q, limit) in enumerate(script):
            if kind == "get":
                want.append(serial.get(q))
                tickets.append((i, pipe.submit_get(q)))
            elif kind == "put":
                want.append(serial.put(q, q ^ np.uint64(0xF)))
                tickets.append((i, pipe.submit_put(q, q ^ np.uint64(0xF))))
            elif kind == "delete":
                want.append(serial.delete(q[:12]))
                tickets.append((i, pipe.submit_delete(q[:12])))
            elif kind == "range":
                want.append(tuple(serial.range(q[:12], limit=limit, max_leaves=1)))
                tickets.append((i, pipe.submit_range(q[:12], limit, max_leaves=1)))
            else:
                want.append(serial.flush())
                got[i] = pipe.flush()
        for i, t in tickets:
            got[i] = pipe.result(t)
            got[i] = tuple(got[i]) if script[i][0] == "range" else got[i]
        for i, (a, b) in enumerate(zip(want, got)):
            if isinstance(a, tuple):
                assert all(np.array_equal(x, y) for x, y in zip(a, b, strict=True)), (qd, i)
            else:
                assert np.array_equal(a, b), (qd, i)
        for a, b in zip(serial.items(), pipe.items()):
            assert np.array_equal(a, b)
        sa, sb = dataclasses.asdict(serial.stats), dataclasses.asdict(piped.stats)
        for f in ("wave_issue_ns", "wave_drain_ns", "cache_hits", "scan_hits", "scan_probes", "scan_cursor_admits"):
            sa.pop(f), sb.pop(f)
        assert sa == sb, qd
        spans = pipe.span_totals()
        n_waves = sum(kind != "flush" for kind, _, _ in script)
        assert sum(c for k, (_, c) in spans.items() if k.endswith("/issue")) == n_waves, spans
        assert serial.stats.flush_cycles > 0 and spans["kv/write/serial"][1] >= 1, spans


def _same_answer(a, b, what):
    """One call's answers on the card and on the CPU are identical."""
    if hasattr(a, "counts"):
        a, b = tuple(a), tuple(b)
    if isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            _same_answer(x, y, what)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a.cpu(), b.cpu()), what
    elif isinstance(a, dict):
        assert a == b, what
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), what


@pytest.mark.cuda
def test_sharded_tiers_on_the_card_equal_the_cpu(cuda_device):
    """The hash tier and the replicated range tier on the card and on the
    CPU, one seeded stream: GET, PUT, DELETE, RANGE (``k_max``, ``fanout``,
    one leaf a round), the issue and finalize halves, a primary kill with
    old-epoch reads, retire and recovery, a reshard 3 -> 4, both device
    waves over ``stacked()``: every answer, ``items()`` and the counters
    identical."""
    from repro_torch.core import TreeConfig, datasets
    from repro_torch.core.keys import limbs_to_tensor, split_u64
    from repro_torch.distributed import kvshard, rangeshard
    from repro_torch.kernels import build

    keys = datasets.sparse(30000, seed=9)
    vals = keys ^ np.uint64(0x5EED)
    rng = np.random.default_rng(2)
    for part, R in (("hash", 1), ("range", 2)):
        pair = [kvshard.ShardedDPAStore(keys, vals, 3, TreeConfig(growth=16.0), partition=part, replication=R,
                                        device=d) for d in (cuda_device, "cpu")]

        def both(name, *args, **kw):
            outs = [getattr(s, name)(*args, **kw) for s in pair]
            _same_answer(*outs, (part, name))
            return outs[0]

        before = dict(build.launches)
        for step in range(4):
            q = np.concatenate([rng.choice(keys, 3000), rng.integers(0, 2**64 - 1, 500, dtype=np.uint64)])
            both("get", q)
            newk = rng.integers(1, 2**63, 800, dtype=np.uint64)
            both("put", newk, newk ^ np.uint64(step))
            both("delete", rng.choice(keys, 300))
            starts = q[:512]
            both("range", starts, 10)
            both("range", starts, 40, max_leaves=1, k_max=starts + np.uint64(2**50))
            if part == "range":
                both("range", starts, 20, fanout=2)
            outs = [s.get_finalize(s.get_issue(q[:1000])) for s in pair]
            _same_answer(*outs, (part, "get halves"))
            outs = [s.range_finalize(s.range_issue(starts, 10)) for s in pair]
            _same_answer(*outs, (part, "range halves"))
            both("flush")
        if part == "range":
            both("kill_replica", 0)
            ep = pair[0].boundary_epoch - 1
            both("get", q, epoch=ep)
            both("range", starts, 10, epoch=ep)
            both("retire_failover")
            both("recover_replicas")
            both("reshard", 4)
            both("get", q)
            both("range", starts, 10)
        for k in ("get", "cache_probe_p1", "range_walk"):
            assert build.launches[k] > before[k], f"{part}: kernel {k} did not run on the card"
        _same_answer(*[s.items() for s in pair], (part, "items"))
        for c in ("range_requests", "range_subqueries", "client_writes", "replica_writes", "acked_writes",
                  "failovers", "recoveries", "reshards", "n_shards"):
            assert getattr(pair[0], c) == getattr(pair[1], c), (part, c)
        assert pair[0].stats_totals() == pair[1].stats_totals()
        stacks = [s.stacked() for s in pair]
        n_s = pair[0].n_shards
        qs = np.concatenate([rng.choice(keys, n_s * 200), rng.integers(0, 2**64 - 1, n_s * 56, dtype=np.uint64)])
        qs = qs.reshape(n_s, 256)
        route = rangeshard.make_route_fn(pair[0].boundaries) if part == "range" else None
        for cap in (256, 40):
            outs = []
            for (tree, ib, depth), s in zip(stacks, pair):
                l = limbs_to_tensor(split_u64(qs), s.device)
                outs.append(kvshard.serve_wave_emulated(tree, ib, l[..., 0].contiguous(), l[..., 1].contiguous(),
                                                        cap=cap, depth=depth, eps_inner=4, eps_leaf=8, route_fn=route))
            _same_answer(*outs, (part, "serve wave", cap))
            if part == "range":
                outs = []
                for (tree, ib, depth), s in zip(stacks, pair):
                    l = limbs_to_tensor(split_u64(qs[:, :16]), s.device)
                    outs.append(rangeshard.range_wave_emulated(
                        tree, ib, l[..., 0].contiguous(), l[..., 1].contiguous(), s.boundaries,
                        cap=cap // 8, depth=depth, eps_inner=4, limit=10, fanout=2))
                _same_answer(*outs, (part, "range wave", cap))


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_equal_the_emulated_waves(cuda_device):
    """2 ``gloo`` ranks on the card (the pools reach them as CUDA IPC
    handles) during a live rebalance: a mixed-epoch GET wave, a GET wave
    at a cap that overflows, the looped RANGE and a mixed-epoch RANGE, each
    bitwise equal to the emulated wave on the card; B1 and B3 launched in
    every rank."""
    from repro_torch.core import TreeConfig, datasets
    from repro_torch.core.keys import limbs_to_tensor, split_u64
    from repro_torch.distributed import kvshard
    from repro_torch.launch.local_ranks import WaveCase, spawn_waves

    keys = datasets.sparse(1400, seed=73)
    st = kvshard.ShardedDPAStore(keys, keys ^ np.uint64(0xE), 2, TreeConfig(growth=16.0), partition="range",
                                 cache_cfg=None, device=cuda_device)
    b_old = st.boundaries.copy()
    storm = keys.max() + np.uint64(1) + np.arange(500, dtype=np.uint64) * np.uint64(3)
    st.put(storm, storm ^ np.uint64(0xE))
    st.flush()
    assert st.begin_rebalance(st.planner.propose(st.boundaries))
    tree, ib, depth = st.stacked()
    rng = np.random.default_rng(2)
    qs = np.concatenate([rng.choice(keys, 16), rng.choice(storm, 8), rng.integers(0, 2**63, 8, dtype=np.uint64)])
    l = limbs_to_tensor(split_u64(qs.reshape(2, 16)), "cpu")
    kh, kl = l[..., 0].contiguous(), l[..., 1].contiguous()
    tag = torch.from_numpy((np.arange(32).reshape(2, 16) % 2).astype(np.int32))
    g = dict(depth=depth, eps_inner=4, eps_leaf=8)
    r = dict(depth=depth, eps_inner=4)
    cases = [
        WaveCase("serve", kh, kl, dict(cap=32, **g), boundaries=st.boundaries, boundaries_prev=b_old, epoch_tag=tag),
        WaveCase("serve", kh, kl, dict(cap=3, **g), boundaries=st.boundaries),
        WaveCase("range", kh, kl, dict(cap=32, limit=40, max_leaves=1, **r), boundaries=st.boundaries),
        WaveCase("range", kh, kl, dict(cap=32, limit=5, max_leaves=8, **r), boundaries=st.boundaries,
                 boundaries_prev=b_old, epoch_tag=tag),
    ]
    outs, reports = spawn_waves([(tree, ib)], cases, device=cuda_device, backend="gloo")
    for i, (case, got) in enumerate(zip(cases, outs)):
        for a, b in zip(got, case.emulated(tree, ib), strict=True):
            assert torch.equal(a, b.cpu()), i
    assert not bool(outs[1][3].all()) and int(outs[2][7].max()) > 1
    for rep in reports:
        assert rep["backend"] == "gloo" and rep["launches"]["get"] > 0 and rep["launches"]["range_walk"] > 0


@pytest.mark.cuda
def test_engine_on_the_card_equals_the_cpu(cuda_device):
    """``Engine`` on the card == on the CPU on the same weights (drawn on the
    CPU, copied over), for a dense, a MoE and a hybrid reduced config:
    greedy tokens equal; the prefill's last logits to one bf16 rounding of
    themselves plus one of their largest magnitude (cuBLAS and the CPU sum
    the products in other orders), the hybrid's to a relative L2 error of
    2^-4 (its mamba layers compound those roundings; ``tests/test_torch_lm.py``
    holds its layers one by one)."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import lm
    from repro_torch.models.carry import to_device
    from repro_torch.serving.engine import Engine, ServeConfig

    for name in ("glm4-9b", "mixtral-8x7b", "jamba-1.5-large-398b"):
        cfg = reduced(ARCHS[name])
        cfg = dataclasses.replace(cfg, n_layers=cfg.superblock)
        params = lm.init(cfg, 0, device="cpu")
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        cpu = Engine(cfg, params, ServeConfig(max_len=32), device="cpu")
        card = Engine(cfg, to_device(params, cuda_device), ServeConfig(max_len=32), device=cuda_device)
        want = cpu.prefill(toks)[1].float()
        got = card.prefill(toks)[1].float().cpu()
        if name.startswith("jamba"):
            assert float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) <= 2**-4, name
        else:
            torch.testing.assert_close(got, want, rtol=2**-7, atol=2**-7 * float(want.abs().max()), msg=name)
        np.testing.assert_array_equal(card.generate(toks, 8), cpu.generate(toks, 8), err_msg=name)


@pytest.mark.cuda
def test_train_step_on_the_card_equals_the_cpu(cuda_device):
    """One ``make_train_step`` step (AdamW, 2 microbatches, block remat) on
    the card == on the CPU from the same state (drawn on the CPU, copied
    over) on the same batch: the loss and gradient norm to a relative 2^-7,
    each moment leaf to a relative L2 error of 2^-5, every parameter within
    ``2 * lr`` plus one bf16 ulp and at most a 2^-5 share beyond one ulp
    (the tolerances of ``tests/test_torch_training.py``: cuBLAS and the CPU
    sum the products in other orders)."""
    from repro_torch.checkpoint.manager import tree_flatten
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.carry import to_device
    from repro_torch.training import optimizer
    from repro_torch.training import train_step as ts

    lr = 1e-3
    for name in ("glm4-9b", "mixtral-8x7b"):
        cfg = reduced(ARCHS[name])
        tcfg = ts.TrainConfig(opt=optimizer.OptConfig(lr=lr), microbatches=2)
        cpu = ts.init_state(cfg, tcfg, 0, device="cpu")
        card = to_device(cpu, cuda_device)
        batch = SyntheticLM(cfg, ShapeConfig("t", 64, 4, "train"), DataConfig(seed=3)).global_batch(0)
        tb = {k: (None if v is None else torch.from_numpy(v)) for k, v in batch.items()}
        step = ts.make_train_step(cfg, tcfg)
        card, mg = step(card, {k: (None if v is None else v.to(cuda_device)) for k, v in tb.items()})
        cpu, mc = step(cpu, tb)
        for k in ("loss", "grad_norm"):
            assert abs(float(mg[k]) - float(mc[k])) <= 2**-7 * abs(float(mc[k])), (name, k)
        for k in ("m", "v"):
            for a, b in zip(tree_flatten(card["opt"][k])[0], tree_flatten(cpu["opt"][k])[0]):
                assert float(torch.linalg.vector_norm(a.cpu() - b) / torch.linalg.vector_norm(b)) <= 2**-5, (name, k)
        beyond = total = 0
        for a, b in zip(tree_flatten(card["params"])[0], tree_flatten(cpu["params"])[0]):
            want = b.float().numpy()
            d = np.abs(a.float().cpu().numpy() - want)
            ulp = np.spacing(np.abs(want)) * 2.0**16
            assert (d <= 2 * lr + ulp).all(), name
            beyond += int((d > ulp).sum())
            total += want.size
        assert beyond <= 2**-5 * total, (name, beyond, total)


def _step_leaves(state):
    from repro_torch.checkpoint.manager import tree_flatten

    return [x.cpu() for x in tree_flatten(state)[0]]


def _train_states_close(card, cpu, lr, what):
    """The tolerances of ``test_train_step_on_the_card_equals_the_cpu``:
    each moment leaf to a relative L2 error of 2^-5, every parameter within
    ``2 * lr`` plus one bf16 ulp, at most a 2^-5 share beyond one ulp."""
    for k in ("m", "v"):
        for a, b in zip(_step_leaves(card["opt"][k]), _step_leaves(cpu["opt"][k])):
            assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)) <= 2**-5, (what, k)
    beyond = total = 0
    for a, b in zip(_step_leaves(card["params"]), _step_leaves(cpu["params"])):
        want = b.float().numpy()
        d = np.abs(a.float().numpy() - want)
        ulp = np.spacing(np.abs(want)) * 2.0**16
        assert (d <= 2 * lr + ulp).all(), what
        beyond += int((d > ulp).sum())
        total += want.size
    assert beyond <= 2**-5 * total, (what, beyond, total)


@pytest.mark.cuda
def test_three_microbatches_on_the_card_equal_the_cpu(cuda_device, monkeypatch):
    """``microbatches=3`` divides the f32 accumulator and the loss by 3, a
    count whose reciprocal is inexact: on the same per-microbatch gradients
    and losses (drawn from a seed, fed in place of the backward) the card's
    accumulated gradients and loss equal the CPU's bitwise; the clip scale
    ``grad_clip / gnorm`` at ``grad_clip=1e-3`` equals the CPU's bitwise on
    2^16 norms; and a real step of reduced glm4 at 3 microbatches is within
    the train step's card-vs-CPU tolerances."""
    from repro_torch.checkpoint.manager import tree_unflatten
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.carry import to_device
    from repro_torch.training import optimizer
    from repro_torch.training import train_step as ts

    lr = 1e-3
    cfg = reduced(ARCHS["glm4-9b"])
    tcfg = ts.TrainConfig(opt=optimizer.OptConfig(lr=lr), microbatches=3)
    cpu = ts.init_state(cfg, tcfg, 0, device="cpu")
    batch = SyntheticLM(cfg, ShapeConfig("t", 64, 6, "train"), DataConfig(seed=3)).global_batch(0)
    tb = {k: (None if v is None else torch.from_numpy(v)) for k, v in batch.items()}

    # the accumulation alone: drawn gradients and losses in place of the backward
    real_vg, real_update = ts._value_and_grad, optimizer.update
    taken = []

    def drawn(cfg_, params, mb):
        rng = np.random.default_rng(int(mb["tokens"][0, 0]))
        leaves = _step_leaves(params)
        g = [torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)).to(p.dtype) for p in leaves]
        dev = mb["tokens"].device
        loss = torch.tensor(rng.normal() + 10.0, dtype=torch.float32, device=dev)
        return loss, {}, tree_unflatten(params, [x.to(dev) for x in g])

    def recorded(ocfg, params, grads, state):
        taken.append(_step_leaves(grads))
        return real_update(ocfg, params, grads, state)

    monkeypatch.setattr(ts, "_value_and_grad", drawn)
    monkeypatch.setattr(optimizer, "update", recorded)
    step = ts.make_train_step(cfg, tcfg)
    _, mc = step(ts.init_state(cfg, tcfg, 0, device="cpu"), tb)
    _, mg = step(to_device(cpu, cuda_device), {k: (None if v is None else v.to(cuda_device)) for k, v in tb.items()})
    assert float(mg["loss"]) == float(mc["loss"])
    for a, b in zip(taken[1], taken[0]):
        assert torch.equal(a, b)
    monkeypatch.setattr(ts, "_value_and_grad", real_vg)
    monkeypatch.setattr(optimizer, "update", real_update)

    gn = torch.from_numpy(np.random.default_rng(5).lognormal(0.0, 3.0, 1 << 16).astype(np.float32))
    ocfg = optimizer.OptConfig(grad_clip=1e-3)
    assert torch.equal(optimizer.clip_scale(ocfg, gn.to(cuda_device)).cpu(), optimizer.clip_scale(ocfg, gn))

    step = ts.make_train_step(cfg, tcfg)
    card, mg = step(to_device(cpu, cuda_device), {k: (None if v is None else v.to(cuda_device)) for k, v in tb.items()})
    cpu, mc = step(cpu, tb)
    for k in ("loss", "grad_norm"):
        assert abs(float(mg[k]) - float(mc[k])) <= 2**-7 * abs(float(mc[k])), k
    _train_states_close(card, cpu, lr, "microbatches=3")


@pytest.mark.cuda
def test_paired_causal_train_step_on_the_card_equals_the_cpu(cuda_device, monkeypatch):
    """A reduced glm4 step with ``paired_causal`` at 1024 tokens (two
    512-token blocks: the paired branch is taken in every layer, counted on
    both devices) on the card == on the CPU to the train step's tolerances."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import layers
    from repro_torch.models.carry import to_device
    from repro_torch.training import optimizer
    from repro_torch.training import train_step as ts

    calls = []
    inner = layers._paired_causal
    monkeypatch.setattr(layers, "_paired_causal", lambda *a: calls.append(a[0].device.type) or inner(*a))
    lr = 1e-3
    cfg = reduced(ARCHS["glm4-9b"])
    tcfg = ts.TrainConfig(opt=optimizer.OptConfig(lr=lr))
    cpu = ts.init_state(cfg, tcfg, 0, device="cpu")
    card = to_device(cpu, cuda_device)
    batch = SyntheticLM(cfg, ShapeConfig("t", 1024, 1, "train"), DataConfig(seed=3)).global_batch(0)
    tb = {k: (None if v is None else torch.from_numpy(v)) for k, v in batch.items()}
    step = ts.make_train_step(cfg, tcfg)
    layers.set_perf_flags(paired_causal=True)
    try:
        card, mg = step(card, {k: (None if v is None else v.to(cuda_device)) for k, v in tb.items()})
        cpu, mc = step(cpu, tb)
    finally:
        layers.set_perf_flags()
    assert calls.count("cuda") >= cfg.n_layers and calls.count("cpu") == calls.count("cuda")
    for k in ("loss", "grad_norm"):
        assert abs(float(mg[k]) - float(mc[k])) <= 2**-7 * abs(float(mc[k])), k
    _train_states_close(card, cpu, lr, "paired_causal")


@pytest.mark.cuda
def test_moe_decode_gather_on_the_card_equals_the_cpu(cuda_device):
    """Reduced mixtral through ``Engine`` with ``moe_decode_gather`` (batch
    2: 2 tokens top-2 of 4 experts, the gather path at every decode step):
    greedy tokens equal, the prefill's last logits to one bf16 rounding of
    themselves plus one of their largest magnitude."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import layers, lm
    from repro_torch.models.carry import to_device
    from repro_torch.serving.engine import Engine, ServeConfig

    cfg = reduced(ARCHS["mixtral-8x7b"])
    cfg = dataclasses.replace(cfg, n_layers=cfg.superblock)
    params = lm.init(cfg, 0, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    layers.set_perf_flags(moe_decode_gather=True)
    try:
        cpu = Engine(cfg, params, ServeConfig(max_len=32), device="cpu")
        card = Engine(cfg, to_device(params, cuda_device), ServeConfig(max_len=32), device=cuda_device)
        want = cpu.prefill(toks)[1].float()
        got = card.prefill(toks)[1].float().cpu()
        torch.testing.assert_close(got, want, rtol=2**-7, atol=2**-7 * float(want.abs().max()))
        np.testing.assert_array_equal(card.generate(toks, 8), cpu.generate(toks, 8))
    finally:
        layers.set_perf_flags()


@pytest.mark.cuda
def test_means_and_counts_round_once_on_the_card(cuda_device):
    """The training path's means (``layers.mean``: rms_norm, Adafactor's
    factored and RMS means, the MoE aux loss, the CE mean) and its
    divisions by a count (``layers.count``: rope's frequencies, the
    microbatch mean) round once on the card as on the CPU: each mean is the
    f64 quotient of the card's own f32 sum rounded to f32, at counts that
    are not powers of two (13696 is glm4-9b's d_ff) and at one that is
    (``torch.mean``, whose reciprocal is exact); each quotient by a count
    equals the CPU's bitwise."""
    from repro_torch.models import layers

    rng = np.random.default_rng(6)
    for shape, dim in (((3, 13696), -1), ((96, 13696), -2), ((7, 123), None), ((2, 5, 40), -1), ((4, 4096), -1)):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
        s = x.sum() if dim is None else x.sum(dim=dim)
        n = x.numel() if dim is None else x.shape[dim]
        assert torch.equal(layers.mean(x, dim), (s.double() / n).float()), (shape, dim)
    a = torch.from_numpy(rng.normal(size=1 << 16).astype(np.float32))
    for n in (3, 40, 64, 13696):
        assert torch.equal((a.to(cuda_device) / layers.count(n, a.to(cuda_device))).cpu(), a / layers.count(n, a)), n


@pytest.mark.cuda
def test_btree_get_on_the_card_equals_the_cpu(cuda_device):
    """The B+-tree baseline's pools and ``get_batch`` on the card == on the
    CPU bitwise (100k keys, depth 3; present, absent and KEY_MAX-adjacent
    requests), and every present key found."""
    from repro_torch.core import btree, datasets
    from repro_torch.core.keys import KEY_MAX, split_u64

    keys = datasets.sparse(100_000, seed=3)
    vals = keys ^ np.uint64(0xBEEF)
    trees = [btree.build(keys, vals, device=d) for d in (cuda_device, "cpu")]
    assert trees[0].depth == 3
    rng = np.random.default_rng(4)
    q = np.concatenate([rng.choice(keys, 4096), rng.integers(0, 2**64 - 1, 1024, dtype=np.uint64),
                        np.array([0, KEY_MAX, KEY_MAX - np.uint64(1)], np.uint64)])
    limbs = split_u64(q).view(np.int32)
    out = [btree.get_batch(t, *(torch.from_numpy(limbs[:, i].copy()).to(t.node_keys.device) for i in (0, 1)))
           for t in trees]
    for a, b in zip(*out):
        assert torch.equal(a.cpu(), b)
    assert bool(out[1][2][:4096].all())
