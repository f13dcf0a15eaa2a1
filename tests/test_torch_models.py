"""Port ``models/layers``, ``moe`` and ``mamba`` == the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed; JAX parameters are carried into
torch with ``repro_torch.models.carry``, so both packages compute on the
same weights.  The JAX functions run as written (eagerly, op by op), as the
JAX package's own tests call them.

Tolerances: a bf16 output may differ from JAX's by one bf16 rounding
(``BF16``: rtol 2^-7, atol 2^-10), where the two frameworks sum an f32
product or reduction in another order before rounding; f32 SSM states by
rtol 1e-4 / atol 1e-5 (the chunk products summed in another order); the
MoE aux loss by rtol 1e-6 (an f32 mean over tokens).  The MoE routing
decisions (expert ids, kept slots, capacity) are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro_torch.models import layers, mamba, moe
from repro_torch.models.carry import from_numpy, to_numpy

BF16 = dict(rtol=2**-7, atol=2**-10)
STATE = dict(rtol=1e-4, atol=1e-5)


def _pair(a, dtype=jnp.bfloat16):
    """The same array for both packages: (jax array, torch tensor)."""
    j = jnp.asarray(a).astype(dtype)
    return j, from_numpy(np.asarray(j), "cpu")


def _close(j, t, tol):
    np.testing.assert_allclose(to_numpy(t), np.asarray(j, np.float32), **tol)


def test_rms_norm_and_rope_equal_jax():
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.normal(size=(2, 40, 64)) * 3)
    jw, tw = _pair(rng.normal(size=(64,)))
    _close(jlayers.rms_norm(jx, jw, 1e-6), layers.rms_norm(tx, tw, 1e-6), BF16)
    jq, tq = _pair(rng.normal(size=(2, 64, 4, 16)))
    pos = rng.integers(0, 70000, (2, 64)).astype(np.int32)  # large angles: f32 sin/cos argument reduction
    for theta in (10_000.0, 1e6):
        _close(jlayers.rope(jq, jnp.asarray(pos), theta), layers.rope(tq, torch.from_numpy(pos), theta), BF16)


_ATTN = {
    "full-causal": (64, dict(causal=True, block_q=16, block_kv=16)),
    "full-bidirectional": (64, dict(causal=False, block_q=16, block_kv=32)),
    "one-block": (64, dict(causal=True)),
    "window-subquadratic": (64, dict(causal=True, flavor="window", window=16, block_q=16, block_kv=16)),
    "window-wider-than-S": (64, dict(causal=True, flavor="window", window=100, block_q=16, block_kv=16)),
    "chunk": (64, dict(causal=True, flavor="chunk", chunk=16, block_q=8, block_kv=8)),
    "q-offset": (16, dict(causal=True, q_offset=48, block_q=16, block_kv=16)),
    "paired": (64, dict(causal=True, block_q=16, block_kv=16, causal_scheme="paired")),
}


@pytest.mark.parametrize("case", sorted(_ATTN))
def test_blockwise_attention_equals_jax(case):
    """Every flavour of ``blockwise_attention``: the masked scan (causal and
    not, one block and several), the sub-quadratic window path (window <
    S) and its masked fallback (window >= S), block-diagonal chunks, a
    prefill continuation at ``q_offset``, and the paired causal schedule,
    which also equals the masked scan."""
    sq, kw = _ATTN[case]
    rng = np.random.default_rng(1)
    jq, tq = _pair(rng.normal(size=(2, sq, 4, 16)))
    jk, tk = _pair(rng.normal(size=(2, 64, 2, 16)))
    jv, tv = _pair(rng.normal(size=(2, 64, 2, 16)))
    got = layers.blockwise_attention(tq, tk, tv, **kw)
    assert got.shape == (2, sq, 4, 16) and got.dtype == torch.bfloat16
    _close(jlayers.blockwise_attention(jq, jk, jv, **kw), got, BF16)
    if case == "paired":
        masked = layers.blockwise_attention(tq, tk, tv, causal=True, block_q=16, block_kv=16)
        np.testing.assert_allclose(to_numpy(got), to_numpy(masked), **BF16)


def test_blockwise_attention_refuses_ragged_blocks():
    t = torch.zeros((1, 48, 2, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples"):
        layers.blockwise_attention(t, t, t, causal=True, block_q=32, block_kv=32)


def test_swiglu_equals_jax():
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.normal(size=(2, 40, 64)))
    ws = [_pair(rng.normal(size=s) * s[0] ** -0.5) for s in ((64, 128), (64, 128), (128, 64))]
    _close(jlayers.swiglu(jx, *[w[0] for w in ws]), layers.swiglu(tx, *[w[1] for w in ws]), BF16)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_params(key, E, tie=None):
    jp = jmoe.init(jax.random.key(key), 64, 128, E, jnp.bfloat16)
    if tie is not None:  # two experts with the same router column: every token ties them
        a, b = tie
        jp = jp._replace(router=jp.router.at[:, b].set(jp.router[:, a]))
    return jp, moe.MoEParams(**from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu"))


def _jax_dispatch(jp, jx, top_k, cf):
    """The reference's routing (``moe.py:57-112``) in the JAX package's ops,
    then its dispatch order, ranks and kept slots replayed in numpy."""
    T = jx.shape[0] * jx.shape[1]
    E = jp.router.shape[1]
    xf = jx.reshape(T, -1)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf.astype(jnp.float32), jp.router), axis=-1)
    _, eids = jax.lax.top_k(probs, top_k)
    eids = np.asarray(eids)
    flat = eids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    eid_s = flat[order]
    rank = np.zeros_like(eid_s)
    for i in range(1, eid_s.size):
        rank[i] = rank[i - 1] + 1 if eid_s[i] == eid_s[i - 1] else 0
    C = max(1, int(round(T * top_k / E * cf)))
    keep = rank < C
    return eids, np.where(keep, eid_s * C + rank, E * C), keep, C, np.repeat(np.arange(T), top_k)[order]


@pytest.mark.parametrize(
    "case,B,S,E,top_k,skew,tie",
    [
        ("prefill-overflows", 2, 40, 8, 2, 4.0, None),
        ("decode-capacity-1", 2, 1, 8, 2, 8.0, None),
        ("top-1-ties", 2, 24, 4, 1, 0.0, (1, 3)),
        ("top-2-ties", 1, 7, 8, 2, 0.0, (2, 5)),
    ],
)
def test_moe_apply_routes_and_drops_like_jax(case, B, S, E, top_k, skew, tie):
    """``moe.apply``: expert ids, the dispatch order, kept slots and the
    capacity exactly as the reference's; aux and output to tolerance.  The
    prefill's tokens share a bias that sends most of them to the same
    experts, overflowing C; at decode (2 tokens, top-2 of 8) C rounds to
    1 and the two near-equal tokens collide; with two identical router
    columns every token ties and the lower expert wins, as in
    ``jax.lax.top_k``."""
    rng = np.random.default_rng(3)
    jp, tp = _moe_params(4, E, tie)
    x = rng.normal(size=(B, S, 64)) + skew * rng.normal(size=(1, 1, 64))
    jx, tx = _pair(x)
    jout, jaux = jmoe.apply(jp, jx, top_k=top_k)
    tout, taux = moe.apply(tp, tx, top_k=top_k)
    eids, slot, keep, C, tok_s = _jax_dispatch(jp, jx, top_k, 1.25)
    r = moe.route(tp, tx.reshape(B * S, 64), top_k=top_k, capacity_factor=1.25)
    assert r.capacity == C
    np.testing.assert_array_equal(r.eids.numpy(), eids)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.tok_s.numpy(), tok_s)
    if case in ("prefill-overflows", "decode-capacity-1", "top-1-ties"):
        assert not keep.all(), "the case must drop tokens"
    if tie is not None:  # the higher of the tied pair is never chosen without the lower
        a, b = tie
        assert torch.equal(r.probs[:, a], r.probs[:, b]) and (eids == a).any()
        assert ((eids == a).any(axis=1) | ~(eids == b).any(axis=1)).all()
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    _close(jout, tout, BF16)


# ---------------------------------------------------------------------------
# mamba
# ---------------------------------------------------------------------------

_MKW = dict(expand=2, head_dim=16, state=16, conv=4)


def _mamba_params():
    jp = jmamba.init(jax.random.key(5), 64, dtype=jnp.bfloat16, **_MKW)
    return jp, mamba.MambaParams(**from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu"))


def _state(st):
    return mamba.MambaState(*from_numpy([np.asarray(st.h), np.asarray(st.conv)], "cpu"))


def test_mamba_apply_scan_equals_jax():
    """The chunked SSD at S = 100 (not a multiple of 64: the chunk drops to
    50), with and without ``return_state``, then continued from that state
    (``init_state``) over 64 more steps."""
    rng = np.random.default_rng(6)
    jp, tp = _mamba_params()
    jx, tx = _pair(rng.normal(size=(2, 100, 64)))
    _close(jmamba.apply_scan(jp, jx, **_MKW), mamba.apply_scan(tp, tx, **_MKW), BF16)
    jo, js = jmamba.apply_scan(jp, jx, return_state=True, **_MKW)
    to, ts = mamba.apply_scan(tp, tx, return_state=True, **_MKW)
    _close(jo, to, BF16)
    _close(js.h, ts.h, STATE)
    _close(js.conv, ts.conv, BF16)
    jx2, tx2 = _pair(rng.normal(size=(2, 64, 64)))
    jo, js2 = jmamba.apply_scan(jp, jx2, init_state=js, return_state=True, **_MKW)
    to, ts2 = mamba.apply_scan(tp, tx2, init_state=_state(js), return_state=True, **_MKW)
    _close(jo, to, BF16)
    _close(js2.h, ts2.h, STATE)


def test_mamba_apply_step_equals_jax():
    """Three recurrent steps from the same prefill state."""
    rng = np.random.default_rng(7)
    jp, tp = _mamba_params()
    jx, _ = _pair(rng.normal(size=(2, 20, 64)))
    _, js = jmamba.apply_scan(jp, jx, return_state=True, **_MKW)
    ts = _state(js)
    for _ in range(3):
        jx1, tx1 = _pair(rng.normal(size=(2, 1, 64)))
        jo, js = jmamba.apply_step(jp, jx1, js, **_MKW)
        to, ts = mamba.apply_step(tp, tx1, ts, **_MKW)
        _close(jo, to, BF16)
        _close(js.h, ts.h, STATE)
        _close(js.conv, ts.conv, BF16)
