"""Port ``models/lm``, ``Engine`` and the LM launcher == the JAX package's, on the CPU.

Every family the repo has, at ``reduced(...)`` with ``n_layers =
superblock``: dense full attention (glm4), window (h2o-danube), chunk +
full with a shared expert (llama4-scout), MoE (mixtral), SSM (mamba2),
hybrid (jamba), an ``embeds`` frontend (pixtral) and the bidirectional
encoder (hubert).  The JAX parameters are carried into torch
(``repro_torch.models.carry``), inputs are drawn with numpy from a seed.

The JAX reference runs op by op under ``jax.disable_jit()``: each of its
ops is then rounded as written.  Compiled, XLA fuses the scanned
superblock and moves the bf16 roundings, so its logits differ from its
own eager run by a few bf16 ulps, and a routing decision on a near-tie
can flip.  Against the eager run the port agrees in logits and caches to
one bf16 rounding at the tensor's scale (``BF16``: each element within
2^-7 of itself plus 2^-7 of the tensor's largest magnitude: an f32 sum in
another order moves a hidden state by one rounding, and that moves a small
logit by a rounding of the large ones; the f32 SSM states, built from
such bf16 inputs, to the same), aux losses to rtol 1e-4 (the MoE layers' f32 means, summed in
another order); routing decisions show in the logits (a flipped expert
moves them far past the tolerance), and greedy tokens are compared exactly.
``Engine`` is also held against the JAX ``Engine`` as it runs (jitted
decode step) on the dense config.
"""

import contextlib
import dataclasses
import io
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.carry import from_numpy, to_numpy
from repro_torch.serving.engine import Engine, ServeConfig

ROOT = Path(__file__).resolve().parents[1]
BF16 = dict(rtol=2**-7, scale=2**-7)  # atol = scale * max |expected|
# the hybrid's seven mamba layers compound one-rounding differences (XLA's
# and torch's f32 exp, rsqrt and cumsum differ in the last bit) until a
# router near-tie flips for a few tokens: its whole-model prefill is held to
# this relative L2 error of the logits, each of its layers strictly by
# test_layers_equal_jax_teacher_forced, and its decode steps strictly
COMPOUNDING = {"jamba-1.5-large-398b": 2**-4}
FAMILIES = [
    "glm4-9b",
    "h2o-danube-3-4b",
    "llama4-scout-17b-a16e",
    "mixtral-8x7b",
    "mamba2-1.3b",
    "jamba-1.5-large-398b",
    "pixtral-12b",
]


def _configs(name, n_layers=None):
    j = jreduced(JARCHS[name])
    t = reduced(ARCHS[name])
    n = n_layers or j.superblock
    return dataclasses.replace(j, n_layers=n), dataclasses.replace(t, n_layers=n)


def _params(jc, seed=1):
    jp = jlm.init(jc, jax.random.key(seed))
    return jp, from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _inputs(jc, rng, B, S):
    """({'tokens' | 'embeds': jax}, the same for torch)."""
    if jc.frontend != "none":
        a = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)
        return {"embeds": jnp.asarray(a)}, {"embeds": torch.from_numpy(a)}
    a = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": jnp.asarray(a)}, {"tokens": torch.from_numpy(a)}


def _close(j, t, tol=BF16):
    want = np.asarray(j, np.float32)
    tol = dict(tol)
    if "scale" in tol:
        tol["atol"] = tol.pop("scale") * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(to_numpy(t), want, **tol)


def _rel_close(j, t, rel):
    """The whole tensor to a relative L2 error."""
    want = np.asarray(j, np.float32)
    err = np.linalg.norm(to_numpy(t) - want) / np.linalg.norm(want)
    assert err <= rel, f"relative error {err} > {rel}"


def _close_cache(jcache, tcache):
    assert len(jcache["slots"]) == len(tcache["slots"])
    for js, ts in zip(jcache["slots"], tcache["slots"]):
        assert sorted(js) == sorted(ts)
        for k in js:
            assert tuple(js[k].shape) == tuple(ts[k].shape), k
            _close(js[k], ts[k])


B, S, MAX_LEN = 2, 32, 40  # one set of shapes: JAX compiles each eager op once per shape


def _laid_out(jc, pre):
    """The reference ``Engine.prefill``'s copy of a prefill cache into a
    ``MAX_LEN`` cache (the last ``W`` positions to slots ``0..W-1``)."""
    cache = jlm.init_cache(jc, B, MAX_LEN)
    for pc, dst in zip(pre["slots"], cache["slots"]):
        if "k" in dst:
            W = min(pc["k"].shape[2], dst["k"].shape[2])
            dst["k"] = dst["k"].at[:, :, :W].set(pc["k"][:, :, -W:])
            dst["v"] = dst["v"].at[:, :, :W].set(pc["v"][:, :, -W:])
        else:
            dst["h"], dst["conv"] = pc["h"], pc["conv"]
    return cache


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_and_decode_steps_equal_jax(name):
    """``forward`` in train mode (logits, aux) and in prefill mode (logits
    and the per-slot caches with their group dimension), then two
    ``decode_step`` calls from the reference's layout of that prefill cache
    (carried over), each fed the same token: logits and the new caches, to
    ``BF16`` on every family (the hybrid's prefill as ``COMPOUNDING`` says).  The
    ring caches (window and chunk 16 < the 32-token prompt) take the
    reference's copy as it is.  Token ids include ones out of the table
    (JAX counts a negative id from the end, then clamps); on the dense
    config a third step at a position past the cache (the reference's
    ``dynamic_update_slice_in_dim`` clamps the write to the last slot)."""
    jc, tc = _configs(name)
    jp, tp = _params(jc)
    rng = np.random.default_rng(2)
    ja, ta = _inputs(jc, rng, B, S)
    if "tokens" in ja:
        ta["tokens"][0, :3] = torch.tensor([-1, jc.vocab_size + 5, -(jc.vocab_size + 3)])
        ja["tokens"] = jnp.asarray(ta["tokens"].numpy())
    with jax.disable_jit():
        for mode in ("train", "prefill"):
            jl, jaux, jcache = jlm.forward(jc, jp, mode=mode, **ja)
            tl, taux, tcache = lm.forward(tc, tp, mode=mode, **ta)
            assert tl.shape == (B, S, tc.vocab_size) and tl.dtype == torch.bfloat16
            assert (tcache is None) == (mode == "train")
            if name in COMPOUNDING:
                _rel_close(jl, tl, COMPOUNDING[name])
                np.testing.assert_allclose(float(taux), float(jaux), rtol=COMPOUNDING[name])
            else:
                _close(jl, tl)
                np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4)
        if name not in COMPOUNDING:
            # the hybrid's whole-model cache is not: once a router near-tie
            # has flipped, its last mamba slot's state is 7 % off (relative
            # L2); each of its layers' prefill caches is held to BF16 in
            # test_layers_equal_jax_teacher_forced, and its decode steps
            # below start from the reference's cache and are held to BF16
            _close_cache(jcache, tcache)
        jcache = _laid_out(jc, jcache)
        tcache = from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
        before = to_numpy(tcache)
        positions = [S, S + 1] + ([MAX_LEN + 5] if name == "glm4-9b" else [])
        for i, pos in enumerate(positions):
            if jc.frontend != "none":
                tok = rng.normal(size=(B, jc.d_model)).astype(np.float32)
            else:
                tok = np.array([rng.integers(0, jc.vocab_size), -2 - i], np.int32)
            jlog, jcache = jlm.decode_step(jc, jp, jcache, jnp.asarray(tok), jnp.int32(pos))
            tlog, tnew = lm.decode_step(tc, tp, tcache, torch.from_numpy(tok), pos)
            if i == 0:  # the cache passed in is left as it was
                jax.tree.map(np.testing.assert_array_equal, before, to_numpy(tcache))
            tcache = tnew
            assert tlog.shape == (B, tc.vocab_size)
            _close(jlog, tlog)
            _close_cache(jcache, tcache)
    if name == "glm4-9b":  # the clamped write landed in the last slot
        assert bool(tcache["slots"][0]["k"][:, :, MAX_LEN - 1].abs().sum() > 0)


def test_encoder_forward_equals_jax():
    """The bidirectional encoder with an ``embeds`` frontend (hubert), train mode."""
    jc, tc = _configs("hubert-xlarge")
    jp, tp = _params(jc)
    ja, ta = _inputs(jc, np.random.default_rng(1), B, S)
    with jax.disable_jit():
        jl, jaux, _ = jlm.forward(jc, jp, **ja)
    tl, taux, cache = lm.forward(tc, tp, **ta)
    assert cache is None and float(taux) == float(jaux) == 0.0
    _close(jl, tl)


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", "llama4-scout-17b-a16e", "mixtral-8x7b"])
def test_layers_equal_jax_teacher_forced(name):
    """Each layer of the MoE configs (one superblock), prefill
    mode, fed the reference's hidden state: the mixer's output and cache and
    the MLP's output to ``BF16``, and every MoE layer's routing (expert ids,
    kept slots, capacity) exactly; then the final norm and head."""
    from repro.models.layers import rms_norm as jrms
    from repro_torch.models import moe

    jc, tc = _configs(name)
    jp, tp = _params(jc)
    ja, ta = _inputs(jc, np.random.default_rng(3), B, S)
    pos = jnp.arange(S, dtype=jnp.int32)[None].repeat(B, 0)
    tpos = torch.from_numpy(np.array(pos))
    carry = lambda a: from_numpy(np.asarray(a), "cpu")  # noqa: E731
    routed = 0
    with jax.disable_jit():
        x = jp["embed"][ja["tokens"]]
        for g in range(jc.n_layers // jc.superblock):
            for slot in range(jc.superblock):
                jb = jax.tree.map(lambda a: a[g], jp["blocks"][slot])
                tb = lm._at(tp["blocks"][slot], g)
                if jc.layer_kind(slot) == "attn":
                    jy, jcache = jlm._attn_layer(jc, slot, jb, x, pos, "prefill")
                    ty, tcache = lm._attn_layer(tc, slot, tb, carry(x), tpos, "prefill")
                else:
                    jy, jcache = jlm._mamba_layer(jc, jb, x, "prefill")
                    ty, tcache = lm._mamba_layer(tc, tb, carry(x), "prefill")
                _close(jy, ty)
                for k in jcache:
                    _close(jcache[k], tcache[k])
                if jc.mlp_kind(slot) == "moe":
                    h = jrms(jy, jb["ln2"], jc.norm_eps)
                    xf = h.reshape(B * S, -1)
                    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf.astype(jnp.float32), jb["moe"]["router"]), -1)
                    _, eids = jax.lax.top_k(probs, jc.experts_per_token)
                    r = moe.route(moe.MoEParams(**tb["moe"]), carry(xf), top_k=tc.experts_per_token,
                                  capacity_factor=tc.capacity_factor)
                    np.testing.assert_array_equal(r.eids.numpy(), np.asarray(eids))
                    flat = np.asarray(eids).reshape(-1)
                    order = np.argsort(flat, kind="stable")
                    first = np.searchsorted(flat[order], flat[order])
                    rank = np.arange(flat.size) - first
                    np.testing.assert_array_equal(r.keep.numpy(), rank < r.capacity)
                    routed += 1
                jz, _ = jlm._mlp_layer(jc, slot, jb, jy)
                tz, _ = lm._mlp_layer(tc, slot, tb, carry(jy))
                _close(jz, tz)
                x = jz
        _close(jnp.einsum("bsd,dv->bsv", jrms(x, jp["final_norm"], jc.norm_eps), jp["lm_head"]),
               torch.einsum("bsd,dv->bsv", lm.rms_norm(carry(x), tp["final_norm"], tc.norm_eps), tp["lm_head"]))
    assert routed == sum(jc.mlp_kind(i) == "moe" for i in range(jc.superblock))


@pytest.mark.parametrize("name", ["glm4-9b", "mixtral-8x7b"])
def test_engine_generate_equals_jax(name):
    """``Engine.generate``'s greedy tokens and ``prefill``'s cache and last
    logits equal the JAX ``Engine``'s (mixtral decodes 2 tokens at top-2 of
    4 experts: C = 1, tokens are dropped)."""
    jc, tc = _configs(name)
    jp, tp = _params(jc, seed=0)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    with jax.disable_jit():
        je = JEngine(jc, jp, JServeConfig(max_len=MAX_LEN))
        jcache, jlast = je.prefill(toks)
        want = je.generate(toks, 4)
    te = Engine(tc, tp, ServeConfig(max_len=MAX_LEN), device="cpu")
    tcache, tlast = te.prefill(toks)
    _close(jlast, tlast)
    _close_cache(jcache, tcache)
    got = te.generate(toks, 4)
    assert got.shape == (B, 4) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(te.timings["step_s"]) == 4 and te.timings["prefill_s"] > 0


def test_engine_generate_equals_the_jitted_jax_engine():
    """The JAX ``Engine`` as it runs (its decode step jitted) gives the
    port's greedy tokens on the dense config, and ``return_logits`` gives
    the decode steps' logits."""
    jc, tc = _configs("glm4-9b", n_layers=2)
    jp, tp = _params(jc, seed=0)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 8)).astype(np.int32)
    want = JEngine(jc, jp, JServeConfig(max_len=48)).generate(toks, 6)
    got, logits = Engine(tc, tp, ServeConfig(max_len=48), device="cpu").generate(toks, 6, return_logits=True)
    np.testing.assert_array_equal(got, want)
    assert logits.shape == (2, 6, tc.vocab_size)
    np.testing.assert_array_equal(got[:, 1:], logits[:, :-1].argmax(-1).numpy())


def test_engine_refuses_encoders_long_runs_and_sampling():
    """Encoders, a run past ``max_len`` and a non-zero temperature (decode
    is greedy only) raise instead of being served otherwise."""
    tc = dataclasses.replace(reduced(ARCHS["hubert-xlarge"]), n_layers=1)
    with pytest.raises(ValueError, match="encoders"):
        Engine(tc, {}, device="cpu")
    tc = dataclasses.replace(reduced(ARCHS["glm4-9b"]), n_layers=1)
    params = lm.init(tc, 0, device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        Engine(tc, params, ServeConfig(temperature=0.8), device="cpu")
    eng = Engine(tc, params, ServeConfig(max_len=10), device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(np.zeros((1, 8), np.int32), 3)


def test_engine_default_serveconfig_not_shared():
    """The twin of the JAX package's ``test_engine_default_serveconfig_not_shared``."""
    cfg = reduced(ARCHS["glm4-9b"])
    params = lm.init(cfg, 0, device="cpu")
    e1, e2 = Engine(cfg, params, device="cpu"), Engine(cfg, params, device="cpu")
    assert e1.scfg is not e2.scfg
    e1.scfg.max_len = 7777  # must not leak into other engines
    assert e2.scfg.max_len != 7777


def test_init_lays_params_out_as_the_reference():
    """``lm.init`` gives the reference's tree: names, shapes and dtypes, with
    the leading group dimension, for a hybrid MoE config and a chunk + full
    config with a shared expert; the same seed draws the same weights."""
    for name in ("jamba-1.5-large-398b", "llama4-scout-17b-a16e"):
        jc, tc = _configs(name, n_layers=2 * JARCHS[name].superblock)
        want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jax.eval_shape(lambda k: jlm.init(jc, k), jax.random.key(0)))
        got = lm.init(tc, 3, device="cpu")
        shapes = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got)
        assert shapes == want
        again = lm.init(tc, 3, device="cpu")
        jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), got, again)
    spec = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jlm.cache_spec(jc, 2, 40))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), lm.init_cache(tc, 2, 40, "cpu"))
    assert got == spec


def test_serve_lm_cli_on_the_cpu():
    """``launch/serve.py --arch glm4-9b --reduced --steps 4 --device cpu``
    generates and reports prefill ms, decode ms a step and tokens/s."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", "glm4-9b", "--reduced", "--steps", "4", "--device", "cpu"])
    out = buf.getvalue()
    assert "generated (2, 4) tokens" in out and "ms a step" in out and "tokens/s" in out, out
    assert "prefill" in out and "on the CPU" in out


def test_torch_kv_serve_example_on_the_cpu(capsys):
    """``examples/torch_kv_serve.py --device cpu`` at a tiny size, mixes B
    (GET + UPDATE) and E (RANGE + INSERT)."""
    example = runpy.run_path(str(ROOT / "examples" / "torch_kv_serve.py"))
    for mix in ("B", "E"):
        example["main"](["--workload", mix, "--device", "cpu", "--n-keys", "5000", "--waves", "3",
                         "--wave-size", "256"])
        out = capsys.readouterr().out
        assert "wave   2:" in out and "768 ops" in out and "on cpu" in out, out
