"""The port's sharded train step, its launcher under several ranks and its
dry run on a fake group, on the CPU.

One spawn of 2 ``gloo`` ranks on a ``(2, 1)`` mesh and one of 4 on
``(2, 2)`` (``launch.local_ranks.spawn_train``), each running four cases
from states carried in from the JAX package's ``init_state``: reduced glm4
with AdamW, reduced mixtral (the MoE layer's global dispatch), reduced
jamba with Adafactor (its factored moments on; two microbatches) and
reduced glm4 with gradient compression (each leaf's scale from its
all-reduced max).  Each
case's two steps are held against the port's one-process step, its first
step against the reference's, and each rank's blocks have the shapes of
the reference's specs.  Then ``launch/train.py`` restarted under 2 ranks,
and ``launch/dryrun.py`` on a fake ``(2, 2)`` group at reduced sizes.

Tolerances, those of ``tests/test_torch_training.py``: losses and the
gradient norm relative 2^-7; each first-moment leaf relative L2 2^-5 (the
gradients' tolerance) and each second-moment leaf (``v``, ``vr``, ``vc``:
squares of the gradient, twice its relative error) 2^-4; every parameter
within ``2 lr`` a step plus one bf16 ulp, and after the first step at
most a 2^-5 share beyond one ulp.  After the second step, whose gradients
are taken at parameters the first step's differences moved, the moments
are held as whole trees (each kind's relative L2 over all its leaves) to
the same tolerances: a few small mamba and router leaves of jamba move up
to 2^-3.3 there (the reference's own jamba LM parity is 2^-4), and an
Adafactor update, not sign-like, moves some 4 % of the parameters by an
ulp.  With gradient compression the moments are held as whole trees from
the first step (an int8 level flips where the two gradients straddle its
boundary: a whole level on one element), and after the first step the
error feedback each element within one level (the leaf's scale, to the
gradients' 2^-5) of the one process's.  The ranks' gradients are bf16 sums of their rows' (a
reduce of rounded halves where one process rounds the whole once), so a
gradient element near 0 may flip its sign and its AdamW update by ``2 lr``.
The launcher's restart is bitwise; the dry run's bytes and flops exact.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import pipeline as jpipeline
from repro.distributed import sharding as jshd
from repro.training import optimizer as joptimizer
from repro.training import train_step as jts
from repro_torch.checkpoint.manager import CheckpointManager, tree_flatten
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.local_ranks import spawn_launcher, spawn_train
from repro_torch.models import moe
from repro_torch.models.carry import from_numpy, to_numpy
from repro_torch.training import optimizer
from repro_torch.training import train_step as ts

pytestmark = pytest.mark.timeout(300)

LOSS_RTOL = 2**-7
GRAD_REL = 2**-5
SQUARE_REL = 2**-4  # a second moment: the gradient squared
LR = 1e-3
B, S = 8, 32
CASES = {  # name -> (arch, optimizer config, microbatches, gradient compression)
    "glm4-adamw": ("glm4-9b", {}, 1, False),
    "mixtral-dispatch": ("mixtral-8x7b", {}, 1, False),
    "jamba-adafactor": ("jamba-1.5-large-398b", {"factored_min": 32}, 2, False),
    "glm4-compression": ("glm4-9b", {}, 1, True),
}


class _JMesh:
    def __init__(self, sizes, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _configs(arch):
    j, t = jreduced(JARCHS[arch]), reduced(ARCHS[arch])
    return dataclasses.replace(j, n_layers=j.superblock), dataclasses.replace(t, n_layers=t.superblock)


def _case(name):
    arch, opt, mb, comp = CASES[name]
    jc, tc = _configs(arch)
    jt = jts.TrainConfig(opt=joptimizer.OptConfig(kind=jc.optimizer, lr=LR, **opt), microbatches=mb,
                         grad_compression=comp)
    tt = ts.TrainConfig(opt=optimizer.OptConfig(kind=tc.optimizer, lr=LR, **opt), microbatches=mb,
                        grad_compression=comp)
    assert tt.opt.kind == ("adafactor" if "adafactor" in name else "adamw")
    jstate = jts.init_state(jc, jt, jax.random.key(3))
    data = jpipeline.SyntheticLM(jc, JShapeConfig("t", S, B, "train"), jpipeline.DataConfig(seed=1))
    batches = [data.global_batch(i) for i in range(2)]
    return jc, tc, jt, tt, jstate, batches


def _tbatch(b):
    return {k: (None if v is None else torch.from_numpy(v)) for k, v in b.items()}


def _state(jstate):
    return from_numpy(jax.tree.map(np.asarray, jstate), "cpu")


def _block_slices(shape, spec, sizes, names, coords):
    """The rank at ``coords``' block of a leaf of ``shape`` under the
    reference's ``spec`` (row-major over a dim's axes)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for n, ax in zip(shape, spec):
        axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
        idx, parts = 0, 1
        for a in axes:
            i = names.index(a)
            idx, parts = idx * sizes[i] + coords[i], parts * sizes[i]
        out.append(slice(idx * n // parts, (idx + 1) * n // parts))
    return tuple(out)


def _ref_specs(jc, jt, jstate, sizes, names):
    """The reference's specs of the state, in flatten order (the error
    feedback's those of the parameters, as its ``launch/train.py`` places
    it)."""
    m = _JMesh(sizes, names)
    ps = jshd.param_specs(jc, jstate["params"], m)
    specs = {"opt": jshd.opt_specs(jc, jstate["opt"], ps, m, zero=True), "params": ps}
    if "err" in jstate:
        specs["err"] = ps
    return [tuple(p) for p in jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))]


def _moment_tols(jstate):
    """Each state leaf's tolerance, in flatten order: a moment's relative L2,
    ``"err"`` for the error feedback, ``None`` for the parameters."""
    paths = jax.tree_util.tree_flatten_with_path(dict(jstate))[0]
    key = [p[1].key if p[0].key == "opt" else p[0].key for p, _ in paths]
    return [GRAD_REL if k == "m" else SQUARE_REL if k in ("v", "vr", "vc") else "err" if k == "err" else None
            for k in key]


@pytest.fixture(scope="module")
def one_process():
    """Each case's inputs and the port's one-process steps."""
    out = {}
    for name in CASES:
        jc, tc, jt, tt, jstate, batches = _case(name)
        one = _state(jstate)
        step = ts.make_train_step(tc, tt)
        states, metrics = [], []
        for b in batches:
            one, mt = step(one, _tbatch(b))
            states.append([x.clone() for x in tree_flatten(one)[0]])
            metrics.append({k: float(v) for k, v in mt.items()})
        out[name] = {"jc": jc, "tc": tc, "jt": jt, "tt": tt, "jstate": jstate, "batches": batches, "one": states,
                     "one_metrics": metrics}
    return out


@pytest.fixture(scope="module", params=[(2, 1), (2, 2)], ids=["2x1", "2x2"])
def run(request, one_process):
    """One spawn per mesh: every case's two steps on each rank."""
    mesh = request.param
    cases = [(c["tc"], c["tt"], _state(c["jstate"]), [_tbatch(b) for b in c["batches"]]) for c in one_process.values()]
    reports = spawn_train(cases, mesh=mesh, device="cpu")
    return mesh, {name: {**one_process[name], "ranks": rep} for name, rep in zip(CASES, reports)}


def _assert_rel(want, got, rtol, what):
    assert abs(got - want) <= rtol * abs(want), f"{what}: {got} vs {want}"


def _assert_state_close(want_leaves, got_leaves, specs, tols, sizes, names, coords, steps, what, metrics=None):
    """Each block of ``got`` against the same block of the whole ``want``:
    moments by relative L2 (``tols``; each leaf after one step without
    compression, each kind's whole tree otherwise), parameters within
    ``2 lr`` a step plus an ulp; after one step with compression (its
    ``metrics``), the error feedback within one int8 level of each leaf."""
    whole_trees = steps > 1 or "err" in tols
    err_leaves = [i for i, t in enumerate(tols) if t == "err"]
    m_leaves = [i for i, t in enumerate(tols) if t == GRAD_REL]
    beyond = total = 0
    trees = {}
    for i, (w, g, sp, tol) in enumerate(zip(want_leaves, got_leaves, specs, tols)):
        blk = w[_block_slices(tuple(w.shape), sp, sizes, names, coords)]
        assert tuple(blk.shape) == tuple(g.shape), (what, i)
        a, b = to_numpy(blk).astype(np.float64), to_numpy(g).astype(np.float64)
        if g.dtype == torch.bfloat16:  # a parameter
            ulp = np.spacing(np.abs(a).astype(np.float32)).astype(np.float64) * 2.0**16
            d = np.abs(b - a)
            assert (d <= 2 * LR * steps + ulp).all(), (what, i, float(d.max()))
            beyond += int((d > ulp).sum())
            total += a.size
        elif tol == "err":
            if steps == 1:  # one level: the leaf's scale max|x| / 127, read off m = 0.1 clip q scale (max |q| = 127)
                m = to_numpy(want_leaves[m_leaves[err_leaves.index(i)]]).astype(np.float64)
                clip = min(1.0, 1.0 / max(metrics["grad_norm"], 1e-9))
                level = np.abs(m).max() / (0.1 * clip * 127)
                assert (np.abs(b - a) <= (1 + GRAD_REL) * level).all(), (what, i)
        elif tol is None:  # an f32 parameter (the MoE router)
            d = np.abs(b - a)
            assert (d <= 2 * LR * steps + np.spacing(np.abs(a).astype(np.float32))).all(), (what, i, float(d.max()))
        elif a.ndim and a.size > 1:  # a moment
            if whole_trees:
                num, den, _ = trees.get(tol, (0.0, 0.0, tol))
                trees[tol] = (num + float(np.sum((b - a) ** 2)), den + float(np.sum(a**2)), tol)
                continue
            den = np.linalg.norm(a)
            err = np.linalg.norm(b - a) / den if den else np.linalg.norm(b)
            assert err <= tol, (what, i, err)
        else:
            np.testing.assert_array_equal(a, b)  # the step counter, an unused sentinel
    for num, den, tol in trees.values():
        assert (num / den) ** 0.5 <= tol, (what, tol, (num / den) ** 0.5)
    if steps == 1:
        assert beyond <= GRAD_REL * total, (what, beyond, total)


@pytest.mark.parametrize("name", list(CASES))
def test_two_sharded_steps_equal_the_one_process_step(run, name):
    """Both steps' loss, ce, aux and gradient norm, and each rank's blocks
    of the state after each step, against the one-process port step."""
    mesh, out = run
    case = out[name]
    sizes, names = mesh, ("data", "model")
    specs = _ref_specs(case["jc"], case["jt"], case["jstate"], sizes, names)
    for r, rep in enumerate(case["ranks"]):
        for k, (want, got) in enumerate(zip(case["one_metrics"], rep["metrics"])):
            assert sorted(want) == sorted(got)
            for key in want:
                if want[key] == 0:
                    assert got[key] == 0, (name, r, k, key)
                else:
                    _assert_rel(want[key], got[key], LOSS_RTOL, f"{name} rank {r} step {k} {key}")
            _assert_state_close(case["one"][k], rep["blocks"][k], specs, _moment_tols(case["jstate"]), sizes, names,
                                rep["coordinate"], k + 1, f"{name} rank {r} step {k}", case["one_metrics"][k])
    if name == "mixtral-dispatch":  # the global dispatch: every rank's aux is the one process's
        for rep in case["ranks"]:
            _assert_rel(case["one_metrics"][0]["aux"], rep["metrics"][0]["aux"], 1e-6, "aux")


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_blocks_of_the_reference_specs(run, name):
    """Each rank's block shapes are the reference's specs' shard shapes, and
    the ranks of a ``model`` group together hold each leaf once."""
    mesh, out = run
    case = out[name]
    leaves = jax.tree.leaves(dict(case["jstate"]))
    specs = _ref_specs(case["jc"], case["jt"], case["jstate"], mesh, ("data", "model"))
    for rep in case["ranks"]:
        want = [tuple(s.stop - s.start for s in _block_slices(np.shape(x), sp, mesh, ("data", "model"),
                                                              rep["coordinate"]))
                for x, sp in zip(leaves, specs)]
        assert rep["block_shapes"] == want
        assert rep["block_bytes"] == sum(rep["blocks"][-1][i].numel() * rep["blocks"][-1][i].element_size()
                                         for i in range(len(want)))
    if mesh == (2, 2):  # something is split over each axis
        shapes = case["ranks"][0]["block_shapes"]
        assert any(s != tuple(np.shape(x)) for s, x in zip(shapes, leaves))
        assert any("model" in str(sp) for sp in specs) and any("data" in str(sp) for sp in specs)


def test_first_sharded_step_equals_the_reference(run):
    """Reduced glm4's first sharded step against the reference's jitted
    step from the same state on the same batch."""
    mesh, out = run
    case = out["glm4-adamw"]
    jnew, jm = jax.jit(jts.make_train_step(case["jc"], case["jt"]))(
        case["jstate"], {k: (None if v is None else jnp.asarray(v)) for k, v in case["batches"][0].items()})
    want = [np.asarray(x) for x in jax.tree.leaves(dict(jnew))]
    specs = _ref_specs(case["jc"], case["jt"], case["jstate"], mesh, ("data", "model"))
    for r, rep in enumerate(case["ranks"]):
        for key in ("loss", "ce", "grad_norm"):
            _assert_rel(float(jm[key]), rep["metrics"][0][key], LOSS_RTOL, f"rank {r} {key}")
        _assert_state_close([from_numpy(w, "cpu") for w in want], rep["blocks"][0], specs,
                            _moment_tols(case["jstate"]), mesh, ("data", "model"), rep["coordinate"], 1,
                            f"rank {r} vs the reference")


def test_every_rank_reports_its_collectives(run):
    """The gradients come back through collectives: all-reduces (a leaf
    replicated over ``data``), reduce-scatters where the MoE input was
    gathered, all-gathers of the ZeRO-split moments' parameters; a rank of
    a ``(2, 2)`` mesh gathers its ``model``-split parameters too."""
    mesh, out = run
    for name, case in out.items():
        kinds = [set(rep["collectives"][0]) for rep in case["ranks"]]
        assert all(k == kinds[0] for k in kinds), name
        assert {"all-reduce", "all-gather"} <= kinds[0], name
        if name == "mixtral-dispatch":
            assert "reduce-scatter" in kinds[0]
            rs = case["ranks"][0]["collectives"][0]["reduce-scatter"]
            assert rs["count"] > 0 and rs["bytes"] > 0


def test_the_launcher_restarted_under_two_ranks_equals_an_uninterrupted_run(tmp_path):
    """``launch/train.py`` on 2 ranks: 4 steps with a checkpoint every 2,
    the same command again (it restores step 4 from rank 0's files, each
    rank its blocks) and an uninterrupted 8-step run: the losses and the
    final state equal bitwise."""
    argv = ["--reduced", "--batch", "4", "--seq", "32", "--device", "cpu", "--lr", "1e-3"]
    ck = ["--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ck")]
    ranks = spawn_launcher([argv + ["--steps", "4"] + ck, argv + ["--steps", "4"] + ck, argv + ["--steps", "8"]],
                           2, device="cpu")
    for r in ranks:
        first, resumed, whole = r
        assert first["losses"] + resumed["losses"] == whole["losses"]
        assert whole["losses"][-1] < whole["losses"][0]
    assert ranks[0][0]["losses"] == ranks[1][0]["losses"]
    a, b = tree_flatten(ranks[0][1]["state"])[0], tree_flatten(ranks[0][2]["state"])[0]
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert CheckpointManager(tmp_path / "ck").latest_step() == 8


# ---------------------------------------------------------------- the dry run


def _one_process_flops(cfg, shape, tcfg):
    st = ts.init_state(cfg, tcfg, torch.Generator(), device="meta")
    b = {k: (None if v is None else torch.empty(v[0], dtype=v[1], device="meta"))
         for k, v in dryrun.input_specs(cfg, shape).items()}
    with FlopCounterMode(display=False) as f:
        ts.make_train_step(cfg, tcfg)(st, b)
    return f.get_total_flops()


@pytest.mark.parametrize("arch", ["glm4-9b", "mixtral-8x7b"])
def test_dryrun_on_a_fake_2x2_group(arch, monkeypatch):
    """At reduced sizes (train, 8 x 64 tokens, 2 microbatches) on a fake
    ``(2, 2)`` group: ``argument_bytes`` equals the reference's specs' shard
    bytes of the state and batch exactly; ``cost.flops`` times the 2 data
    ranks equals the one-process count on the meta device, apart from the
    MoE layers' work, which every rank does whole (the global dispatch):
    measured as what the count loses when ``moe.apply`` does nothing."""
    jc, tc = jreduced(JARCHS[arch]), reduced(ARCHS[arch])
    shape = ShapeConfig("t", 64, 8, "train")
    sizes, names = (2, 2), ("data", "model")
    rec = dryrun.dry_run(tc, shape, sizes, names, mb_override=2)
    assert rec["microbatches"] == 2 and rec["accum_dtype"] == "float32"
    jt = jts.TrainConfig(opt=joptimizer.OptConfig(kind=jc.optimizer))
    jstate = jax.eval_shape(lambda: jts.init_state(jc, jt, jax.random.key(0)))
    leaves = jax.tree.leaves({"opt": jstate["opt"], "params": jstate["params"]})
    want = 0
    for x, sp in zip(leaves, _ref_specs(jc, jt, jstate, sizes, names)):
        blk = _block_slices(x.shape, sp, sizes, names, (0, 0))
        want += int(np.prod([s.stop - s.start for s in blk])) * x.dtype.itemsize
    want += 2 * (shape.global_batch // 2) * shape.seq_len * 4  # tokens and labels, split over data
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["temp_bytes"] is None and "memory.peak_bytes" in rec["not_measured"]
    assert {"all-gather", "all-reduce"} <= set(rec["collectives"])
    assert rec["collective_bytes_per_device"] == sum(v["bytes"] for v in rec["collectives"].values())
    tcfg = ts.TrainConfig(opt=optimizer.OptConfig(kind=tc.optimizer), microbatches=2)
    whole = _one_process_flops(tc, shape, tcfg)
    monkeypatch.setattr(moe, "apply", lambda p, x, **kw: (x * 1, torch.zeros((), device=x.device)))
    whole_dense = _one_process_flops(tc, shape, tcfg)
    rank_dense = dryrun.dry_run(tc, shape, sizes, names, mb_override=2)["cost"]["flops"]
    moe_flops = whole - whole_dense
    assert (moe_flops > 0) == (tc.n_experts > 0)
    assert rank_dense * 2 == whole_dense
    assert rec["cost"]["flops"] == (whole - moe_flops) / 2 + moe_flops


def test_dryrun_cli_writes_its_records(tmp_path):
    """``main`` on reduced shapes is the production CLI's job; here one
    supported and one unsupported cell through ``run_cell``'s record
    writer, with the reference's keys."""
    rec = dryrun.run_cell("hubert-xlarge", "decode_32k", False, tmp_path)
    assert rec["supported"] is False and "skip_reason" in rec
    saved = json.loads((tmp_path / "hubert-xlarge__decode_32k__pod16x16.json").read_text())
    assert saved == rec
    with pytest.raises(ValueError, match="GSPMD"):
        dryrun.main(["--arch", "glm4-9b", "--shape", "train_4k", "--perf", "attn_pin", "--out", str(tmp_path)])
