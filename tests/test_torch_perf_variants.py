"""The port's perf flags (``layers.set_perf_flags``) == the JAX package's, on the CPU.

Twins of ``tests/test_perf_variants.py``, plus what those tests leave out:
the paired schedule taken inside the full model (at 1024 tokens: the model
calls ``blockwise_attention`` with 512-token blocks, and the paired branch
needs an even number of them, at least 2 — the reference's own 64-token
model test never reaches it), ``block_kv``, the flags that are refused, and
``moe_decode_gather`` against the reference's branch.  Inputs are drawn
with numpy from a seed; JAX parameters are carried into torch.  The JAX
functions run op by op (``jax.disable_jit()`` around the models), as
``tests/test_torch_lm.py`` runs them.

Tolerances, fixed before the first comparison: the reference's own where
a test is its twin (paired == masked to 1e-5 in f32; the paired model's
loss within 1e-3 of the masked one's); port against JAX as in ``tests/test_torch_lm.py`` (logits each
within 2^-7 of themselves plus 2^-7 of the largest magnitude, losses to a
relative 2^-7) and ``tests/test_torch_models.py`` (bf16 outputs rtol 2^-7,
atol 2^-10).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import layers, lm, moe
from repro_torch.models.carry import from_numpy, to_numpy

BF16 = dict(rtol=2**-7, atol=2**-10)
LOGITS = 2**-7  # rtol, and atol as a share of the largest magnitude
LOSS_RTOL = 2**-7
SHARDING_FLAGS = ["attn_q_shard", "attn_scores_shard", "decode_logits_shard", "moe_gathered_shard",
                  "moe_decode_local", "moe_y_shard", "attn_rs", "moe_rs"]


@pytest.fixture(autouse=True)
def _no_flags():
    """Every test starts and ends with both packages' flags cleared."""
    layers.set_perf_flags()
    jlayers.set_perf_flags()
    yield
    layers.set_perf_flags()
    jlayers.set_perf_flags()


def _configs(name, n_layers=None):
    j = jreduced(JARCHS[name])
    t = reduced(ARCHS[name])
    n = n_layers or j.superblock
    return dataclasses.replace(j, n_layers=n), dataclasses.replace(t, n_layers=n)


def _params(jc, seed):
    jp = jlm.init(jc, jax.random.key(seed))
    return jp, from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _close_logits(j, t):
    want = np.asarray(j, np.float32)
    np.testing.assert_allclose(to_numpy(t), want, rtol=LOGITS, atol=LOGITS * float(np.abs(want).max()))


@pytest.fixture
def paired_calls(monkeypatch):
    """Counts the calls of the port's ``_paired_causal``."""
    calls = []
    inner = layers._paired_causal

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    monkeypatch.setattr(layers, "_paired_causal", counted)
    return calls


# ---------------------------------------------------------------- attention


def test_paired_causal_equals_masked_fwd_and_grad(paired_calls):
    """The twin of the reference's test (f32, 8 blocks of 16): paired ==
    masked forward and gradient to 1e-5; the ``paired_causal`` flag routes
    the default scheme to the paired schedule and gives its numbers bitwise;
    the port's gradient through the paired schedule equals the reference's."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((2, 128, 8, 16), (2, 128, 4, 16), (2, 128, 4, 16)))
    kw = dict(causal=True, block_q=16, block_kv=16)
    masked = layers.blockwise_attention(q, k, v, **kw)
    paired = layers.blockwise_attention(q, k, v, causal_scheme="paired", **kw)
    assert len(paired_calls) == 1
    torch.testing.assert_close(paired, masked, rtol=0, atol=1e-5)
    assert torch.equal(paired, masked)  # the same blocks in the same order

    def grad(scheme):
        qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        layers.blockwise_attention(*qkv, causal_scheme=scheme, **kw).float().sum().backward()
        return [x.grad for x in qkv]

    g_paired, g_masked = grad("paired"), grad("masked")
    for a, b in zip(g_paired, g_masked):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    # dq bit for bit; dk and dv summed over the query blocks in another order
    assert torch.equal(g_paired[0], g_masked[0])

    layers.set_perf_flags(paired_causal=True)
    flagged = layers.blockwise_attention(q, k, v, **kw)
    assert len(paired_calls) == 3  # two paired runs above, this one
    assert torch.equal(flagged, paired)
    assert all(torch.equal(a, b) for a, b in zip(grad("masked"), g_paired))

    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    jg = jax.grad(lambda x: jnp.sum(jlayers.blockwise_attention(x, jk, jv, causal_scheme="paired", **kw)))(jq)
    np.testing.assert_allclose(g_paired[0].numpy(), np.asarray(jg), rtol=0, atol=1e-5)


def test_block_kv_flag_equals_jax(paired_calls):
    """``block_kv=1024`` on 2048 tokens (512-token Q blocks, 1024-token KV
    blocks), causal and not: port == JAX with the flag on in both, the same
    numbers as passing ``block_kv=1024`` (the flag wins over the argument,
    before the clamp to the sequence), and a ``paired_causal`` flag beside
    it stays off (the paired schedule needs block_q == block_kv)."""
    rng = np.random.default_rng(1)
    shapes = ((1, 2048, 4, 16), (1, 2048, 2, 16), (1, 2048, 2, 16))
    arrays = [rng.normal(size=s) for s in shapes]
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    t = [from_numpy(np.asarray(a), "cpu") for a in j]
    for causal in (True, False):
        plain = layers.blockwise_attention(*t, causal=causal, block_kv=1024)
        layers.set_perf_flags(block_kv=1024, paired_causal=True)
        jlayers.set_perf_flags(block_kv=1024, paired_causal=True)
        got = layers.blockwise_attention(*t, causal=causal, block_kv=64)
        want = jlayers.blockwise_attention(*j, causal=causal, block_kv=64)
        layers.set_perf_flags()
        jlayers.set_perf_flags()
        assert torch.equal(got, plain), causal
        np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), **BF16)
    assert not paired_calls
    # the clamp: a flag larger than the sequence is cut to it
    layers.set_perf_flags(block_kv=4096)
    short = [x[:, :512] for x in t]
    assert torch.equal(layers.blockwise_attention(*short, causal=True),
                       layers.blockwise_attention(*short, causal=True, block_kv=512))


# ---------------------------------------------------------------- flags


def test_perf_flags_do_not_leak():
    layers.set_perf_flags(paired_causal=True)
    layers.set_perf_flags()
    assert layers.PERF_FLAGS == {}
    layers.set_perf_flags(paired_causal=True, block_kv=None, moe_decode_gather=False)
    assert layers.PERF_FLAGS == {"paired_causal": True, "moe_decode_gather": False}


@pytest.mark.parametrize("name", SHARDING_FLAGS + ["moe_bf16_combine", "unroll_attn", "paired"])
def test_unknown_and_sharding_flags_raise(name):
    """The reference's sharding hints (by design: they pin layouts of a
    tensor-parallel program) and unknown names are refused, even beside a
    known flag, and leave the flags as they were: a flag is never taken and
    ignored.  ``moe_bf16_combine``, refused until the port sharded, is now
    taken like the other flags that change the computation."""
    layers.set_perf_flags(block_kv=256)
    if name == "moe_bf16_combine":
        layers.set_perf_flags(paired_causal=True, **{name: True})
        assert layers.PERF_FLAGS == {"paired_causal": True, name: True}
        return
    with pytest.raises(ValueError, match=name):
        layers.set_perf_flags(paired_causal=True, **{name: True})
    assert layers.PERF_FLAGS == {"block_kv": 256}


# ---------------------------------------------------------------- the full model


def test_paired_causal_inside_full_model(paired_calls):
    """Loss parity on a reduced dense model at 1024 tokens, batch 1 (two
    512-token blocks: the shortest sequence on which the model's attention
    takes the paired schedule): the paired loss within 1e-3 of the masked
    one (the reference's bound), the paired branch taken once per layer,
    and the port's paired loss == the reference's with the flag on."""
    jc, tc = _configs("glm4-9b", n_layers=2)
    jp, tp = _params(jc, 3)
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (1, 1024)).astype(np.int32)
    tb = {"tokens": torch.from_numpy(toks), "embeds": None, "labels": torch.from_numpy(toks)}
    with torch.no_grad():
        base, _ = lm.loss_fn(tc, tp, tb)
        assert not paired_calls
        layers.set_perf_flags(paired_causal=True)
        opt, _ = lm.loss_fn(tc, tp, tb)
    assert len(paired_calls) == tc.n_layers
    assert abs(float(base) - float(opt)) < 1e-3
    jlayers.set_perf_flags(paired_causal=True)
    jb = {"tokens": jnp.asarray(toks), "embeds": None, "labels": jnp.asarray(toks)}
    with jax.disable_jit():
        want, _ = jlm.loss_fn(jc, jp, jb)
    assert abs(float(opt) - float(want)) <= LOSS_RTOL * abs(float(want))


# ---------------------------------------------------------------- MoE


def test_moe_bf16_combine_close_to_f32():
    """The twin of the reference's test (reduced mixtral, 2 x 32 tokens),
    which holds the bf16 combine near the f32 one.  At top-2 the
    reference's bf16 combine gives its f32 logits bit for bit (the experts'
    outputs are bf16 already, and 0 + a + b rounds to bf16 once either
    way); the port's logits with the flag on == the reference's."""
    jc, tc = _configs("mixtral-8x7b")
    assert tc.experts_per_token <= 2
    jp, tp = _params(jc, 0)
    toks = np.random.default_rng(0).integers(0, tc.vocab_size, (2, 32)).astype(np.int32)
    layers.set_perf_flags(moe_bf16_combine=True)
    with torch.no_grad():
        got, _, _ = lm.forward(tc, tp, tokens=torch.from_numpy(toks))
    with jax.disable_jit():
        base, _, _ = jlm.forward(jc, jp, tokens=jnp.asarray(toks))
        jlayers.set_perf_flags(moe_bf16_combine=True)
        want, _, _ = jlm.forward(jc, jp, tokens=jnp.asarray(toks))
    np.testing.assert_array_equal(np.asarray(want, np.float32), np.asarray(base, np.float32))
    _close_logits(want, got)


def _moe_case(E, T, seed):
    rng = np.random.default_rng(seed)
    jp = jmoe.init(jax.random.key(seed), 64, 128, E, jnp.bfloat16)
    tp = moe.MoEParams(**from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu"))
    # near-equal tokens: they prefer the same experts, so the dense path overflows C = 1
    x = rng.normal(size=(T, 1, 64)) * 0.3 + 4.0 * rng.normal(size=(1, 1, 64))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    return jp, tp, jx, from_numpy(np.asarray(jx), "cpu")


def _plain_gather(tp, tx, top_k):
    """Each token through its routed experts in f32, gated and summed."""
    xf = tx.reshape(tx.shape[0] * tx.shape[1], -1)
    r = moe.route(tp, xf, top_k=top_k, capacity_factor=1.25)
    out = torch.zeros(xf.shape, dtype=torch.float32)
    for t in range(xf.shape[0]):
        for j in range(top_k):
            e = int(r.eids[t, j])
            g = xf[t].float() @ tp.w_gate[e].float()
            u = xf[t].float() @ tp.w_up[e].float()
            out[t] += r.gate_vals[t, j] * ((torch.nn.functional.silu(g) * u) @ tp.w_down[e].float())
    return out, r


@pytest.mark.parametrize("E,T", [(8, 4), (4, 2), (8, 3)])
def test_moe_decode_gather_equals_jax_and_drops_nothing(E, T):
    """``moe.apply`` with ``moe_decode_gather`` at ``T * top_k <= E`` (the
    mixtral decode shape, 4 tokens top-2 of 8; the reduced one, 2 of 4; an
    odd count): output and aux == the reference's branch; the dense path
    drops entries of these tokens (C = 1), the gather path none: each token
    equals the f32 sum over both of its experts to bf16's rounding."""
    jp, tp, jx, tx = _moe_case(E, T, seed=E + T)
    dense, _ = moe.apply(tp, tx, top_k=2)
    want_plain, r = _plain_gather(tp, tx, 2)
    assert not bool(r.keep.all()), "the dense path must drop entries here"
    layers.set_perf_flags(moe_decode_gather=True)
    jlayers.set_perf_flags(moe_decode_gather=True)
    got, aux = moe.apply(tp, tx, top_k=2)
    want, jaux = jmoe.apply(jp, jx, top_k=2)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), **BF16)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    err = float(torch.linalg.vector_norm(got.reshape(T, -1).float() - want_plain) / torch.linalg.vector_norm(want_plain))
    assert err <= 2**-6, err
    assert float(torch.linalg.vector_norm(dense.reshape(T, -1).float() - want_plain)) > 10 * float(
        torch.linalg.vector_norm(got.reshape(T, -1).float() - want_plain)), "dropped entries must show"
    # more tokens than the branch takes: the dense path, as in the reference
    jp2, tp2, jx2, tx2 = _moe_case(E, E, seed=1)
    np.testing.assert_allclose(to_numpy(moe.apply(tp2, tx2, top_k=2)[0]),
                               np.asarray(jmoe.apply(jp2, jx2, top_k=2)[0], np.float32), **BF16)


def test_moe_decode_gather_decode_step_equals_jax():
    """A reduced mixtral decode step at batch 2 (2 tokens top-2 of 4
    experts: the branch is taken) with ``moe_decode_gather``: logits and
    == the reference's with the flag on, from the same full window ring."""
    jc, tc = _configs("mixtral-8x7b")
    jp, tp = _params(jc, 2)
    assert 2 * tc.experts_per_token <= tc.n_experts
    rng = np.random.default_rng(4)
    # a full window ring of drawn keys and values, as a 16-token prefill leaves it
    jcache = jax.tree.map(lambda z: jnp.asarray(rng.normal(size=z.shape)).astype(z.dtype),
                          jlm.init_cache(jc, 2, tc.window))
    tcache = from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    layers.set_perf_flags(moe_decode_gather=True)
    jlayers.set_perf_flags(moe_decode_gather=True)
    with jax.disable_jit():
        for pos in (16, 17):
            tok = rng.integers(0, tc.vocab_size, 2).astype(np.int32)
            jlog, jcache = jlm.decode_step(jc, jp, jcache, jnp.asarray(tok), jnp.int32(pos))
            tlog, tcache = lm.decode_step(tc, tp, tcache, torch.from_numpy(tok), pos)
            _close_logits(jlog, tlog)
