"""Port training path == the JAX package's, on the CPU.

``data/pipeline``, ``layers.cross_entropy``, ``lm.loss_fn`` and its
gradients (one reduced config of each family), block remat,
``training/optimizer``, ``training/compress``, ``training/train_step`` and
``launch/train.py``.  Inputs are drawn with numpy from a seed; JAX params
and train states are carried into torch with ``repro_torch.models.carry``
(and back as numpy), so both packages start from the same state.  The JAX
losses and gradients run op by op under ``jax.disable_jit()`` (compiled,
XLA moves the bf16 roundings), as ``tests/test_torch_lm.py`` runs the
forward.

Tolerances, fixed before the first comparison:

* the data stream and remat on/off: bitwise;
* losses (``loss``, ``ce``, ``aux``) and the gradient norm: relative 2^-7;
  ``cross_entropy`` on the same f32 logits: relative 1e-6;
* each gradient leaf: relative L2 error 2^-5 (the reference's gradients are
  bf16 and come from XLA's transpose rules, not torch's backward formulas;
  every bf16 product and sum rounds once in each, in another order);
* the optimizer on identical carried-in params, grads and state: the
  gradient norm to relative 1e-5 (an f32 sum of some 10^4 squares a leaf,
  in another order), the moments (``m``, ``v``, ``vr``, ``vc``)
  elementwise to 1e-6 of themselves plus 1e-6 of the leaf's largest
  magnitude, every parameter within one bf16 ulp;
* compression on identical inputs: ``q``, the scale, the residual and the
  dequantised gradient exactly;
* one ``make_train_step`` step against the reference's: losses and the
  gradient norm as above, each moment leaf to the gradients' relative L2
  of 2^-5, every parameter within ``2 * lr`` plus one bf16 ulp (AdamW's
  first update is ``lr * (sign(g) + wd * p)``, so an element whose gradient
  is within the gradients' error of 0 may move ``2 * lr`` the other way)
  and at most a ``GRAD_REL`` share of them beyond one ulp (a gradient off
  by a relative 2^-5 can flip the sign of about that share of its
  elements, those within its error of 0); the error feedback of each
  leaf within one quantum (``2 max |e|``) of the reference's, and at most
  1 in 8 of its elements beyond 1/32 of a quantum (an f32 gradient element
  near a boundary of the int8 grid rounds to the neighbouring level).
"""

import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import pipeline as jpipeline
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.training import compress as jcompress
from repro.training import optimizer as joptimizer
from repro.training import train_step as jts
from repro_torch.checkpoint.manager import CheckpointManager, tree_flatten
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.models import layers, lm
from repro_torch.models.carry import from_numpy, to_numpy
from repro_torch.training import compress, optimizer
from repro_torch.training import train_step as ts

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 2**-7
GRAD_REL = 2**-5
MOMENT_RTOL = 1e-6
NORM_RTOL = 1e-5
FAMILIES = ["glm4-9b", "mixtral-8x7b", "mamba2-1.3b", "jamba-1.5-large-398b", "hubert-xlarge", "pixtral-12b"]
B, S = 4, 32  # one set of shapes: JAX compiles each eager op once per shape


def _configs(name, n_layers=None):
    j = jreduced(JARCHS[name])
    t = reduced(ARCHS[name])
    n = n_layers or j.superblock
    return dataclasses.replace(j, n_layers=n), dataclasses.replace(t, n_layers=n)


def _carry(tree):
    """A JAX tree as the same tree of CPU tensors."""
    return from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _batches(jc, seed=0, b=B, s=S):
    """(JAX batch, torch batch) of one step of the reference's stream."""
    data = jpipeline.SyntheticLM(jc, JShapeConfig("tiny", s, b, "train"), jpipeline.DataConfig(seed=seed))
    nb = data.global_batch(0)
    return ({k: (None if v is None else jnp.asarray(v)) for k, v in nb.items()},
            {k: (None if v is None else torch.from_numpy(v)) for k, v in nb.items()})


def _rel_l2(want, got):
    want = np.asarray(want, np.float32)
    got = to_numpy(got).astype(np.float32)
    assert want.shape == got.shape
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else float(np.linalg.norm(got))


def _bf16_ulp(a):
    """One bf16 ulp at each element of the f32 array ``a``."""
    return np.spacing(np.abs(np.asarray(a, np.float32))) * 2.0**16


def _leaves(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), tree_flatten(ttree)[0]
    assert len(jl) == len(tl)
    return list(zip(jl, tl))


def _assert_rel(j, t, rtol, what):
    j, t = float(j), float(t)
    assert abs(t - j) <= rtol * abs(j), f"{what}: {t} vs the reference's {j}"


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("name", ["glm4-9b", "hubert-xlarge", "pixtral-12b"])
def test_synthetic_stream_equals_jax_bitwise(name):
    """``global_batch``, ``shard_batch`` and ``_embeds`` (audio and vision
    frontends) of the copied pipeline == the reference's, bit for bit."""
    jc, tc = _configs(name)
    shape = (16, 8)
    dcfg = dict(seed=5, zipf_alpha=1.2, ngram_period=4)
    ref = jpipeline.SyntheticLM(jc, JShapeConfig("t", *shape, "train"), jpipeline.DataConfig(**dcfg))
    got = pipeline.SyntheticLM(tc, ShapeConfig("t", *shape, "train"), pipeline.DataConfig(**dcfg))
    for step in (0, 3):
        for want, have in [(ref.global_batch(step), got.global_batch(step)),
                           (ref.shard_batch(step, 1, 4), got.shard_batch(step, 1, 4))]:
            assert sorted(want) == sorted(have)
            for k in want:
                if want[k] is None:
                    assert have[k] is None, k
                else:
                    assert want[k].dtype == have[k].dtype, k
                    np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got._embeds(2, 3, 7), ref._embeds(2, 3, 7))


# ---------------------------------------------------------------- loss


def test_cross_entropy_equals_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 9, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 9)).astype(np.int32)
    mask = (rng.random((3, 9)) < 0.6).astype(np.float32)
    zero = np.zeros_like(mask)
    with jax.disable_jit():
        for m in (None, mask, zero):
            want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), None if m is None else jnp.asarray(m))
            got = layers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                       None if m is None else torch.from_numpy(m))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=MOMENT_RTOL)
        # bf16 logits are taken in f32
        jb = jnp.asarray(logits).astype(jnp.bfloat16)
        want = jlayers.cross_entropy(jb, jnp.asarray(labels))
        got = layers.cross_entropy(from_numpy(np.asarray(jb), "cpu"), torch.from_numpy(labels))
        np.testing.assert_allclose(float(got), float(want), rtol=MOMENT_RTOL)


@pytest.mark.parametrize("microbatches,compression", [(1, False), (4, False), (1, True), (3, False)])
def test_train_step_equals_jax(microbatches, compression):
    """One ``make_train_step`` step from the same carried-in state
    (``init_state`` of the reference, as numpy) on the same batch.  (First
    in the file: the gradient tests below reuse its eager JAX compiles.)
    Three microbatches divide the accumulator and the loss by a count that
    is not a power of two."""
    jc, tc = _configs("glm4-9b")
    lr = 1e-3
    jt = jts.TrainConfig(opt=joptimizer.OptConfig(lr=lr), microbatches=microbatches, grad_compression=compression)
    tt = ts.TrainConfig(opt=optimizer.OptConfig(lr=lr), microbatches=microbatches, grad_compression=compression)
    jstate = jts.init_state(jc, jt, jax.random.key(1))
    state = _carry(jstate)
    assert sorted(state) == sorted(jstate)
    jb, tb = _batches(jc, b=B * microbatches)  # each microbatch at the loss test's shapes
    with jax.disable_jit():
        jnew, jm = jts.make_train_step(jc, jt)(jstate, jb)
    new, m = ts.make_train_step(tc, tt)(state, tb)
    assert sorted(m) == sorted(jm)
    for k in jm:
        _assert_rel(jm[k], m[k], LOSS_RTOL, k)
    assert int(new["opt"]["step"]) == 1
    for k in ("m", "v"):
        for a, b in _leaves(jnew["opt"][k], new["opt"][k]):
            assert _rel_l2(a, b) <= GRAD_REL, k
    if compression:
        for a, b in _leaves(jnew["err"], new["err"]):
            a = np.asarray(a)
            quantum = 2 * np.abs(a).max()
            d = np.abs(to_numpy(b) - a)
            assert (d <= quantum).all() and (d > quantum / 32).mean() <= 1 / 8
    beyond = total = 0
    for a, b in _leaves(jnew["params"], new["params"]):
        a = np.asarray(a, np.float32)
        d = np.abs(to_numpy(b) - a)
        ulp = _bf16_ulp(a)
        assert (d <= 2 * lr + ulp).all()
        beyond += int((d > ulp).sum())
        total += a.size
    assert beyond <= GRAD_REL * total, f"{beyond} of {total} parameters beyond one ulp"


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_fn_and_grads_equal_jax(name):
    """``lm.loss_fn`` and its gradients (``torch.autograd.grad`` through
    the port's forward with block remat) against ``jax.value_and_grad`` of
    the reference's, run eagerly, on one reduced config of each family:
    dense, MoE, SSM, hybrid, the audio encoder (unshifted labels, embeds)
    and the vision frontend (embeds).  Every gradient leaf in the
    parameter's dtype and to ``GRAD_REL``; the losses to ``LOSS_RTOL``."""
    jc, tc = _configs(name)
    assert tc.remat == "block"
    jp = jlm.init(jc, jax.random.key(1))
    jb, tb = _batches(jc)
    with jax.disable_jit():
        (jl, jparts), jg = jax.value_and_grad(lambda p: jlm.loss_fn(jc, p, jb), has_aux=True)(jp)
    tl, tparts, tg = ts._value_and_grad(tc, _carry(jp), tb)
    _assert_rel(jl, tl, LOSS_RTOL, "loss")
    for k in ("ce", "aux"):
        _assert_rel(jparts[k], tparts[k], LOSS_RTOL, k)
    for i, (a, b) in enumerate(_leaves(jg, tg)):
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), (i, a.dtype, b.dtype)
        err = _rel_l2(a, b)
        assert err <= GRAD_REL, f"{name}: gradient leaf {i} {a.shape}: relative L2 error {err}"


def test_remat_changes_no_number():
    """``remat="block"`` recomputes each group in the backward pass and
    changes nothing: the loss, its parts and every gradient bitwise equal
    to ``remat="none"`` (a MoE config and a hybrid one, two groups each)."""
    for name in ("mixtral-8x7b", "jamba-1.5-large-398b"):
        tc = reduced(ARCHS[name])
        assert tc.n_layers == 2 * tc.superblock
        params = lm.init(tc, 3, device="cpu")
        _, tb = _batches(jreduced(JARCHS[name]))
        runs = [ts._value_and_grad(dataclasses.replace(tc, remat=r), params, tb) for r in ("block", "none")]
        (l1, p1, g1), (l2, p2, g2) = runs
        assert torch.equal(l1, l2) and all(torch.equal(p1[k], p2[k]) for k in p1), name
        for a, b in zip(tree_flatten(g1)[0], tree_flatten(g2)[0]):
            assert torch.equal(a, b), name


# ---------------------------------------------------------------- optimizer


def _opt_case(kind, seed=0):
    """Params of each kind of leaf (bf16 and f32; factored: 2-D and stacked
    3-D, both sides >= 128; unfactored: small or narrow), gradients large
    enough to engage the clip, and a carried-in state at step 5."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (192, 160), "stack": (2, 130, 144), "narrow": (3, 64, 8), "bias": (40,)}
    jparams = {k: jnp.asarray(rng.normal(size=s) * 0.2).astype(jnp.bfloat16) for k, s in shapes.items()}
    jparams["router"] = jnp.asarray(rng.normal(size=(16, 4)) * 0.3, jnp.float32)
    jgrads = {k: (jnp.asarray(rng.normal(size=v.shape) * 0.5)).astype(v.dtype) for k, v in jparams.items()}
    cfg = joptimizer.OptConfig(kind=kind, lr=1e-2)
    state = joptimizer.init(cfg, jparams)
    state = jax.tree.map(lambda z: jnp.asarray(np.abs(rng.normal(size=z.shape)) * 1e-3, z.dtype), state)
    state["step"] = jnp.asarray(5, jnp.int32)
    if kind == "adamw":
        state["m"] = jax.tree.map(lambda z: jnp.asarray(rng.normal(size=z.shape) * 1e-2, jnp.float32), state["m"])
    return cfg, jparams, jgrads, state


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_update_equals_jax(kind):
    jcfg, jp, jg, jst = _opt_case(kind)
    want_p, want_st, want_m = joptimizer.update(jcfg, jp, jg, jst)
    assert float(want_m["grad_norm"]) > jcfg.grad_clip  # the clip is engaged
    cfg = optimizer.OptConfig(**dataclasses.asdict(jcfg))
    got_p, got_st, got_m = optimizer.update(cfg, _carry(jp), _carry(jg), _carry(jst))
    _assert_rel(want_m["grad_norm"], got_m["grad_norm"], NORM_RTOL, "grad_norm")
    assert int(got_st["step"]) == int(want_st["step"]) == 6 and got_st["step"].dtype == torch.int32
    moments = ("m", "v") if kind == "adamw" else ("vr", "vc")
    assert sorted(got_st) == sorted(want_st) == sorted(("step",) + moments)
    for k in moments:
        for a, b in _leaves(want_st[k], got_st[k]):
            a = np.asarray(a)
            np.testing.assert_allclose(to_numpy(b), a, rtol=MOMENT_RTOL, atol=MOMENT_RTOL * np.abs(a).max(), err_msg=k)
    for a, b in _leaves(want_p, got_p):
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        a = np.asarray(a, np.float32)
        assert (np.abs(to_numpy(b) - a) <= _bf16_ulp(a)).all(), kind


def test_optimizer_init_lays_state_out_as_the_reference():
    for kind in ("adamw", "adafactor"):
        jcfg, jp, _, _ = _opt_case(kind)
        want = joptimizer.init(jcfg, jp)
        got = optimizer.init(optimizer.OptConfig(**dataclasses.asdict(jcfg)), _carry(jp))
        assert sorted(want) == sorted(got)
        for a, b in _leaves(want, got):
            assert tuple(a.shape) == tuple(b.shape) and str(a.dtype) == str(b.dtype).removeprefix("torch.")
            assert not to_numpy(b).any()


def test_clip_scale_equals_jax_bitwise():
    """The clip scale ``grad_clip / max(gnorm, 1e-9)`` at ``grad_clip=1e-3``
    is one rounding of a true division, as in the reference: 64 gradient
    trees of one non-zero element ``k * 2^-8`` (so the norm is exact in
    both packages: torch's f32 ``sqrt`` on the CPU and XLA's can round an
    inexact root apart), each through the reference's ``optimizer.update``
    and the port's; the first moments ``(1 - b1) * scale * g`` bitwise equal
    (a reciprocal times 1e-3 would be a rounding off in about a quarter of
    them)."""
    rng = np.random.default_rng(0)
    jcfg = joptimizer.OptConfig(lr=1e-2, grad_clip=1e-3)
    cfg = optimizer.OptConfig(**dataclasses.asdict(jcfg))
    for _ in range(64):
        g = np.zeros((4, 16), np.float32)
        g.flat[rng.integers(64)] = rng.choice([-1, 1]) * rng.integers(1, 4096) * 2.0**-8
        jp, jg = {"w": jnp.zeros((4, 16), jnp.float32)}, {"w": jnp.asarray(g)}
        _, want, jm = joptimizer.update(jcfg, jp, jg, joptimizer.init(jcfg, jp))
        tp = {"w": torch.zeros((4, 16))}
        _, got, m = optimizer.update(cfg, tp, {"w": torch.from_numpy(g)}, optimizer.init(cfg, tp))
        assert float(m["grad_norm"]) == float(jm["grad_norm"]) > jcfg.grad_clip
        np.testing.assert_array_equal(got["m"]["w"].numpy(), np.asarray(want["m"]["w"]))
        gn = torch.tensor(float(jm["grad_norm"]))
        assert float(optimizer.clip_scale(cfg, gn)) == float(np.float32(1e-3) / np.float32(gn))


@pytest.mark.parametrize("shape,dim", [((3, 13696), -1), ((96, 136), -2), ((7, 123), None), ((2, 5, 40), -1),
                                       ((4, 64), -1)])
def test_mean_and_count_round_once(shape, dim):
    """``layers.mean``, the training path's mean (rms_norm, Adafactor's
    factored and RMS means, the MoE aux loss, the CE mean), is the f32 sum
    over the count rounded once (the f64 quotient of the same sum rounded
    to f32) and bitwise ``torch.mean`` on the CPU, so no CPU number moves;
    ``layers.count`` divides as a Python number does on the CPU.  Counts
    that are not powers of two (13696 is glm4-9b's d_ff) and one that is
    (kept as ``torch.mean``); the card's side is
    ``tests/test_torch_boundaries.py``."""
    x = torch.from_numpy(np.random.default_rng(6).normal(size=shape).astype(np.float32))
    got = layers.mean(x, dim)
    s = x.sum() if dim is None else x.sum(dim=dim)
    n = x.numel() if dim is None else x.shape[dim]
    assert torch.equal(got, (s.double() / n).float())
    assert torch.equal(got, torch.mean(x) if dim is None else torch.mean(x, dim=dim))
    assert torch.equal(x / layers.count(n, x), x / n)


def test_grad_clip_caps_update():
    """The twin of ``tests/test_training.py::test_grad_clip_caps_update``."""
    cfg = optimizer.OptConfig(lr=1.0, grad_clip=1e-3)
    p = {"w": torch.ones((8, 8))}
    g = {"w": torch.full((8, 8), 100.0)}
    st = optimizer.init(cfg, p)
    newp, _, m = optimizer.update(cfg, {"w": p["w"].clone()}, g, st)
    assert float(m["grad_norm"]) > 1.0
    assert float(torch.max(torch.abs(newp["w"] - p["w"]))) < 15.0


# ---------------------------------------------------------------- compression


def test_compression_equals_jax_exactly():
    rng = np.random.default_rng(1)
    g = (rng.normal(size=(64, 48)) * 0.01).astype(np.float32)
    g[3, 5] = 0.5  # one large element sets the scale; many round to 0
    e = (rng.normal(size=g.shape) * 1e-4).astype(np.float32)
    jq, js, jr = jcompress.quantize(jnp.asarray(g), jnp.asarray(e))
    q, s, r = compress.quantize(torch.from_numpy(g), torch.from_numpy(e))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(compress.dequantize(q, s).numpy(), np.asarray(jcompress.dequantize(jq, js)))
    # a tree of bf16 and f32 gradients with carried-in errors
    jg = {"a": jnp.asarray(g).astype(jnp.bfloat16), "b": [jnp.asarray(g[:7] * 3)]}
    je = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape) * 1e-3, jnp.float32), jg)
    want_g, want_e = jcompress.compress_tree(jg, je)
    got_g, got_e = compress.compress_tree(_carry(jg), _carry(je))
    for a, b in _leaves(want_g, got_g) + _leaves(want_e, got_e):
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(to_numpy(b), np.asarray(a, np.float32))
    for a, b in _leaves(jcompress.init_error(jg), compress.init_error(_carry(jg))):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32 and not b.any()


# ---------------------------------------------------------------- train step


CFG = reduced(ARCHS["glm4-9b"])
SHAPE = ShapeConfig("tiny", 64, 8, "train")


def _data(step):
    b = pipeline.SyntheticLM(CFG, SHAPE, pipeline.DataConfig(seed=3)).global_batch(step)
    return {k: (None if v is None else torch.from_numpy(v)) for k, v in b.items()}


def _run(tcfg, steps=10, seed=0):
    state = ts.init_state(CFG, tcfg, seed, device="cpu")
    step_fn = ts.make_train_step(CFG, tcfg)
    losses = []
    for s in range(steps):
        state, m = step_fn(state, _data(s))
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.parametrize("kind,lr,compression,drop", [
    ("adamw", 1e-3, False, 0.1), ("adafactor", 1e-2, False, 0.05), ("adamw", 1e-3, True, 0.1)])
def test_loss_decreases(kind, lr, compression, drop):
    """The twins of ``tests/test_training.py``'s loss-decrease tests (AdamW,
    Adafactor, AdamW with compression), same config, data and margins."""
    losses, _ = _run(ts.TrainConfig(opt=optimizer.OptConfig(kind=kind, lr=lr), grad_compression=compression))
    assert losses[-1] < losses[0] - drop, losses


def test_microbatch_equivalence():
    """The twin of ``tests/test_training.py::test_microbatch_equivalence``:
    mb=1 and mb=4 give (nearly) the same first-step update."""
    t1 = ts.TrainConfig(opt=optimizer.OptConfig(lr=1e-3), microbatches=1)
    t4 = ts.TrainConfig(opt=optimizer.OptConfig(lr=1e-3), microbatches=4)
    s1 = ts.init_state(CFG, t1, 1, device="cpu")
    s4 = ts.init_state(CFG, t4, 1, device="cpu")
    s1n, m1 = ts.make_train_step(CFG, t1)(s1, _data(0))
    s4n, m4 = ts.make_train_step(CFG, t4)(s4, _data(0))
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 5e-2
    for a, b in zip(tree_flatten(s1n["params"])[0], tree_flatten(s4n["params"])[0]):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=2e-2)
    # AdamW's first step moves each parameter by about lr whatever the
    # gradient: the accumulated gradients themselves, as the first moments
    # (1 - b1) clip g, leaf by leaf to the gradients' tolerance
    for a, b in zip(tree_flatten(s1n["opt"]["m"])[0], tree_flatten(s4n["opt"]["m"])[0]):
        assert _rel_l2(a.numpy(), b) <= GRAD_REL


def test_embedding_gradient_sums_in_f32():
    """The embedding's gradient adds each row's contributions in f32 and
    rounds once to bf16: with a zipf id stream (one id thousands of times)
    every element within one bf16 ulp of the exact sum, where adding in
    bf16 is a tenth off on the most frequent row."""
    rng = np.random.default_rng(0)
    V, D = 512, 32
    ids = torch.from_numpy(np.minimum(rng.zipf(1.1, size=(2, 4096)) - 1, V - 1))
    g = torch.from_numpy(rng.normal(size=(2, 4096, D)) * 1e-3).bfloat16()
    table = torch.zeros(V, D, dtype=torch.bfloat16, requires_grad=True)
    lm._embed(table, ids).backward(g)
    exact = torch.zeros(V, D, dtype=torch.float64).index_add_(0, ids.reshape(-1), g.reshape(-1, D).double())
    ulp = np.spacing(np.abs(exact.float().numpy())) * 2.0**16
    assert int(np.bincount(ids.reshape(-1).numpy()).max()) > 1000
    assert table.grad.dtype == torch.bfloat16
    assert (np.abs(table.grad.double().numpy() - exact.numpy()) <= ulp).all()


# ---------------------------------------------------------------- carry + launcher


def test_train_state_carries_both_ways():
    """A JAX train state (params, AdamW or Adafactor state with its step,
    the error feedback) -> tensors -> numpy: every leaf's values, shape and
    dtype kept (bf16 comes back as f32, exactly)."""
    for name in ("glm4-9b", "jamba-1.5-large-398b"):
        jc, _ = _configs(name)
        jt = jts.TrainConfig(opt=joptimizer.OptConfig(kind=jc.optimizer), grad_compression=True)
        jstate = jts.init_state(jc, jt, jax.random.key(2))
        state = _carry(jstate)
        assert sorted(state) == ["err", "opt", "params"] and state["opt"]["step"].dtype == torch.int32
        back = to_numpy(state)
        for a, b in _leaves(jstate, state):
            assert str(a.dtype) == str(b.dtype).removeprefix("torch.") and tuple(a.shape) == tuple(b.shape)
        for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
            np.testing.assert_array_equal(b, np.asarray(a, np.float32 if a.dtype == jnp.bfloat16 else a.dtype))
        again = jax.tree.map(lambda x, like: jnp.asarray(x, like.dtype), back, jstate)
        assert all(bool((a == b).all()) for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(jstate)))


ARGV = ["--reduced", "--batch", "4", "--seq", "32", "--device", "cpu"]


def test_train_cli_restarts_from_its_checkpoint(tmp_path, capsys):
    """4 steps with a checkpoint every 2, then the same command again: it
    restores step 4 (the restored state equal to the saved one bitwise)
    and its losses equal an uninterrupted 8-step run's bitwise."""
    ck = ["--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ck")]
    first, state4 = train.run(train.parse_args(ARGV + ["--steps", "4"] + ck))
    cfg = reduced(ARCHS["glm4-9b"])
    tcfg = ts.TrainConfig(opt=optimizer.OptConfig(kind=cfg.optimizer))
    mgr = CheckpointManager(tmp_path / "ck")
    assert mgr.all_steps() == [2, 4]
    restored = train.restore(mgr, 4, cfg, tcfg, "cpu")
    for a, b in zip(tree_flatten(state4)[0], tree_flatten(restored)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    capsys.readouterr()
    resumed = train.main(ARGV + ["--steps", "4"] + ck)
    assert "[train] restored step 4" in capsys.readouterr().out
    whole = train.main(ARGV + ["--steps", "8"])
    assert first + resumed == whole
    assert whole[-1] < whole[0]


def test_train_cli_restores_a_checkpoint_the_jax_launcher_writes(tmp_path, capsys):
    """A checkpoint written by the reference (``init_state`` from key 7, two
    jitted train steps on the launcher's data stream, its
    ``CheckpointManager.save`` at step 2: the calls ``repro.launch.train``
    makes, without its mesh, whose sharding pins this JAX version refuses)
    restores in the port's launcher bitwise, and the port's next two losses
    equal the reference's to ``LOSS_RTOL``."""
    jc = jreduced(JARCHS["glm4-9b"])
    jt = jts.TrainConfig(opt=joptimizer.OptConfig(kind=jc.optimizer))
    step_fn = jax.jit(jts.make_train_step(jc, jt))
    data = jpipeline.SyntheticLM(jc, JShapeConfig("custom", 32, 4, "train"), jpipeline.DataConfig(seed=train.SEED))
    state = jts.init_state(jc, jt, jax.random.key(train.SEED))
    want = []
    for step in range(4):
        if step == 2:
            JCheckpointManager(str(tmp_path / "jck")).save(2, state, blocking=True)
            saved = jax.tree.map(np.asarray, state)
        b = {k: (None if v is None else jnp.asarray(v)) for k, v in data.global_batch(step).items()}
        state, m = step_fn(state, b)
        want.append(float(m["loss"]))
    cfg = reduced(ARCHS["glm4-9b"])
    tcfg = ts.TrainConfig(opt=optimizer.OptConfig(kind=cfg.optimizer))
    restored = train.restore(CheckpointManager(tmp_path / "jck"), 2, cfg, tcfg, "cpu")
    for a, b in _leaves(saved, restored):
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(to_numpy(b), np.asarray(a, np.float32 if a.dtype == jnp.bfloat16 else a.dtype))
    capsys.readouterr()
    got = train.main(ARGV + ["--steps", "2", "--ckpt-dir", str(tmp_path / "jck")])
    assert "[train] restored step 2" in capsys.readouterr().out
    for j, t in zip(want[2:], got):
        _assert_rel(j, t, LOSS_RTOL, "loss after the restore")


def test_train_cli_writes_a_preemption_checkpoint_on_sigterm(tmp_path):
    """SIGTERM mid-run: the launcher finishes the step, checkpoints it and
    exits 0."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *ARGV, "--steps", "10000", "--ckpt-every", "100000",
           "--ckpt-dir", str(tmp_path / "ck")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("[train] step 1 "):
                proc.send_signal(signal.SIGTERM)
                break
        out, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    lines += out.splitlines(keepends=True)
    assert proc.returncode == 0, lines
    assert "[train] preemption checkpoint written, exiting\n" in lines
    last = int(next(x for x in reversed(lines) if x.startswith("[train] step ")).split()[2])
    assert CheckpointManager(tmp_path / "ck").all_steps() == [last + 1]
