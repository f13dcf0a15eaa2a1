"""Tenant namespaces, admission, the multi-tenant wave scheduler and the
launcher of the port against the JAX package.

* The tenant key functions equal the reference's bitwise, ``limb_tenant``
  included for ids at and above 2^(bits-1), where an arithmetic shift of an
  int32-held limb would turn negative.
* ``AdmissionController`` makes the same decisions and the same summary.
* ``KVWaveDriver`` over the port's ``DPAStore(device="cpu")`` answers every
  request exactly as the JAX ``KVWaveDriver`` over a JAX ``DPAStore`` does (ticket,
  tenant, op, status, result), with the same ``scheduler_summary()`` and
  the same waves in its pipeline's ledger, on the single-store cases of
  ``tests/test_tenants.py`` with their own oracles.
* ``repro_torch.launch.serve.main`` runs its KV loops with ``--device cpu``
  and refuses every option of a tier that is not ported."""

import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp
from repro.core import DPAStore as JaxStore
from repro.core import TreeConfig as JaxTreeConfig
from repro.core import keys as jkeys
from repro.serving import admission as jadmission
from repro.serving.engine import KVWaveDriver as JaxDriver
from repro_torch.core import DPAStore, TreeConfig
from repro_torch.core import keys as keymod
from repro_torch.launch import serve
from repro_torch.serving import admission
from repro_torch.serving.admission import ADMIT_OK, ADMIT_RETRY, AdmissionController, TenantPolicy
from repro_torch.serving.engine import KVWaveDriver

pytestmark = pytest.mark.timeout(300)

bits_st = st.integers(min_value=1, max_value=32)


# ---------------------------------------------------------------------------
# tenant key functions
# ---------------------------------------------------------------------------


@given(bits_st, st.data())
@settings(max_examples=40, deadline=None)
def test_tenant_functions_equal_the_reference(bits, data):
    tid = data.draw(st.integers(0, (1 << bits) - 1))
    lks = np.array(data.draw(st.lists(st.integers(0, 2 ** (64 - bits) - 1), min_size=1, max_size=24)),
                   dtype=np.uint64)
    assert keymod.tenant_capacity(bits) == jkeys.tenant_capacity(bits)
    assert keymod.tenant_span_bits(bits) == jkeys.tenant_span_bits(bits)
    enc = keymod.encode_tenant(tid, lks, bits)
    np.testing.assert_array_equal(enc, jkeys.encode_tenant(tid, lks, bits))
    for a, b in zip(keymod.decode_tenant(enc, bits), jkeys.decode_tenant(enc, bits)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(keymod.tenant_of_np(enc, bits), jkeys.tenant_of_np(enc, bits))
    assert keymod.tenant_floor(tid, bits) == jkeys.tenant_floor(tid, bits)
    assert keymod.tenant_ceil(tid, bits) == jkeys.tenant_ceil(tid, bits)


@given(bits_st, st.lists(st.integers(0, 2**64 - 1), min_size=1, max_size=64))
@settings(max_examples=40, deadline=None)
def test_limb_tenant_equals_the_reference(bits, xs):
    keys = np.array(xs, dtype=np.uint64)
    limbs = keymod.split_u64(keys)
    got = keymod.limb_tenant(torch.from_numpy(limbs[:, 0].view(np.int32).copy()), bits)
    want = np.asarray(jkeys.limb_tenant(jnp.asarray(limbs[:, 0]), bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if bits < 32:
        np.testing.assert_array_equal(got.numpy().astype(np.int64), keymod.tenant_of_np(keys, bits))


def test_limb_tenant_widens_before_the_shift():
    """Ids 128..255 of the default 8-bit prefix: the hi limb is negative as
    an int32, and a plain shift of it would return negative ids."""
    tids = np.arange(120, 256)
    enc = np.concatenate([keymod.encode_tenant(int(t), np.uint64(12345)) for t in tids])
    hi = torch.from_numpy(keymod.split_u64(enc)[:, 0].view(np.int32).copy())
    assert bool((hi < 0).any())
    got = keymod.limb_tenant(hi).numpy()
    np.testing.assert_array_equal(got, tids)
    np.testing.assert_array_equal(got, np.asarray(jkeys.limb_tenant(jnp.asarray(keymod.split_u64(enc)[:, 0]))))


def test_tenant_functions_reject_what_the_reference_rejects():
    for fn, args in (
        ("encode_tenant", (keymod.tenant_capacity(), np.uint64(1))),
        ("encode_tenant", (-1, np.uint64(1))),
        ("encode_tenant", (0, np.uint64(1) << np.uint64(keymod.tenant_span_bits()))),
        ("encode_tenant", (0, np.uint64(1), 0)),
        ("tenant_ceil", (0, 33)),
        ("tenant_ceil", (256, 8)),
    ):
        with pytest.raises(ValueError):
            getattr(jkeys, fn)(*args)
        with pytest.raises(ValueError):
            getattr(keymod, fn)(*args)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


def test_admission_equals_the_reference_on_a_seeded_stream():
    policies = {0: dict(rate=40.0), 1: dict(rate=10.0, burst=25.0, weight=2.0), 2: dict(weight=0.5)}
    mine = AdmissionController({t: TenantPolicy(**p) for t, p in policies.items()},
                               default=TenantPolicy(rate=5.0))
    ref = jadmission.AdmissionController({t: jadmission.TenantPolicy(**p) for t, p in policies.items()},
                                         default=jadmission.TenantPolicy(rate=5.0))
    rng = np.random.default_rng(4)
    now = 0
    decisions = []
    for _ in range(400):
        now += int(rng.integers(0, 3))
        t, n = int(rng.integers(0, 5)), int(rng.integers(0, 60))
        a, b = mine.admit(t, n, now), ref.admit(t, n, now)
        assert a == b and mine.weight(t) == ref.weight(t)
        decisions.append(a)
    assert any(decisions) and not all(decisions)
    assert mine.summary() == ref.summary()
    assert (admission.ADMIT_OK, admission.ADMIT_RETRY) == (jadmission.ADMIT_OK, jadmission.ADMIT_RETRY)
    for bad in (dict(rate=-1.0), dict(weight=0.0), dict(rate=1.0, burst=-1.0)):
        with pytest.raises(ValueError):
            jadmission.TenantPolicy(**bad)
        with pytest.raises(ValueError):
            TenantPolicy(**bad)


# ---------------------------------------------------------------------------
# KVWaveDriver: the port's and the reference's side by side
# ---------------------------------------------------------------------------


def _norm(result):
    if result is None:
        return None
    if isinstance(result, tuple):
        return tuple(np.asarray(x) for x in result)
    if hasattr(result, "counts"):
        return (np.asarray(result.keys), np.asarray(result.vals), np.asarray(result.counts))
    return np.asarray(result)


def _same_reply(a, b):
    assert (a.ticket, a.tenant, a.op, a.status) == (b.ticket, b.tenant, b.op, b.status)
    ra, rb = _norm(a.result), _norm(b.result)
    if ra is None:
        assert rb is None
    elif isinstance(ra, tuple):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    else:
        assert ra.dtype == rb.dtype
        np.testing.assert_array_equal(ra, rb)


class Twin:
    """The port's ``KVWaveDriver`` over the port's store and the reference's over a
    JAX store, fed the same calls; every return value and refusal must be
    the same.  ``drv`` is the port's driver."""

    def __init__(self, keys, vals, admission_policies=None, **kw):
        pol = admission_policies
        self.drv = KVWaveDriver(
            DPAStore(keys, vals, TreeConfig(growth=16.0), cache_cfg=None, device="cpu"),
            admission=None if pol is None else AdmissionController({t: TenantPolicy(**p) for t, p in pol.items()}),
            **kw,
        )
        self.ref = JaxDriver(
            JaxStore(keys, vals, JaxTreeConfig(growth=16.0), cache_cfg=None),
            admission=None if pol is None else jadmission.AdmissionController(
                {t: jadmission.TenantPolicy(**p) for t, p in pol.items()}),
            **kw,
        )

    def request(self, *args, **kw):
        try:
            t = self.drv.request(*args, **kw)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                self.ref.request(*args, **kw)
            raise
        assert t == self.ref.request(*args, **kw)
        assert self.drv.inflight_waves == self.ref.inflight_waves
        return t

    def tick(self, n=1):
        sealed = self.drv.tick(n)
        assert sealed == self.ref.tick(n)
        return sealed

    def drain(self):
        got, want = self.drv.drain(), self.ref.drain()
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_reply(a, b)
        self.check()
        return got

    def check(self):
        assert self.drv.scheduler_summary() == self.ref.scheduler_summary()
        kinds = [(r.seq, r.kind) for r in self.drv.store.ledger.records]
        assert kinds == [(r.seq, r.kind) for r in self.ref.store.ledger.records]


def _tenant_world(n_tenants=3, n_per=256, seed=3):
    """Per-tenant local key spaces, the encoded global store arrays and the
    dict oracle (tenant -> {local key: val}), as tests/test_tenants.py."""
    rng = np.random.default_rng(seed)
    oracle, enc_keys, enc_vals, locals_ = {}, [], [], {}
    for t in range(n_tenants):
        lk = np.unique(rng.integers(1, 1 << 48, 2 * n_per, dtype=np.uint64))[:n_per]
        lv = lk ^ np.uint64(0xA5A5 + t)
        locals_[t] = lk
        oracle[t] = dict(zip(lk.tolist(), lv.tolist()))
        enc_keys.append(keymod.encode_tenant(t, lk))
        enc_vals.append(lv)
    ek = np.concatenate(enc_keys)
    ev = np.concatenate(enc_vals)
    order = np.argsort(ek)
    return oracle, locals_, ek[order], ev[order]


def _check_ranges(tw, oracle, locals_, limit=8, starts_per_tenant=6, seed=11):
    """RANGE waves from per-tenant starts (tenants mixed in flight); every
    row against the tenant's own dict oracle."""
    rng = np.random.default_rng(seed)
    expect = {}
    for t, lk in locals_.items():
        starts = np.concatenate([
            lk[rng.integers(0, len(lk), starts_per_tenant - 2)],
            np.array([0, int(lk.max()) + 1], dtype=np.uint64),
        ]).astype(np.uint64)
        expect[tw.request("range", starts, limit=limit, tenant=t)] = (t, starts)
    replies = {r.ticket: r for r in tw.drain()}
    for tk, (t, starts) in expect.items():
        rep = replies[tk]
        assert rep.status == ADMIT_OK and rep.tenant == t
        res = rep.result
        for i, s in enumerate(starts):
            ks = sorted(k for k in oracle[t] if k >= int(s))[:limit]
            c = int(res.counts[i])
            assert c == len(ks), (t, int(s))
            np.testing.assert_array_equal(res.keys[i, :c], np.array(ks, dtype=np.uint64))
            np.testing.assert_array_equal(res.vals[i, :c], np.array([oracle[t][k] for k in ks], dtype=np.uint64))
            assert (res.keys[i, :c] < (1 << keymod.tenant_span_bits())).all()
    assert tw.drv.leaked_rows == 0


def test_cross_tenant_range_isolation_vs_oracle():
    oracle, locals_, ek, ev = _tenant_world()
    tw = Twin(ek, ev, wave_size=64, tenant_bits=keymod.TENANT_BITS)
    _check_ranges(tw, oracle, locals_)
    rng = np.random.default_rng(23)
    for t, lk in locals_.items():  # updates and deletes, mirrored into the oracle
        upd = lk[rng.integers(0, len(lk), 16)]
        nv = upd ^ np.uint64(0xBEEF)
        tw.request("put", upd, nv, tenant=t)
        for k, v in zip(upd.tolist(), nv.tolist()):
            oracle[t][k] = v
        dele = np.unique(lk[rng.integers(0, len(lk), 8)])
        tw.request("delete", dele, tenant=t)
        for k in dele.tolist():
            oracle[t].pop(k, None)
    assert all(r.status == ADMIT_OK for r in tw.drain())
    _check_ranges(tw, oracle, locals_, seed=29)


def _single_world(n=512, seed=0):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 1 << 40, 2 * n, dtype=np.uint64))[:n]
    return keys, keys ^ np.uint64(0xC0FFEE)


def test_put_without_vals_fails_at_request_time():
    keys, vals = _single_world()
    tw = Twin(keys, vals)
    with pytest.raises(ValueError, match="vals"):
        tw.request("put", keys[:4])
    with pytest.raises(ValueError, match="mismatch"):
        tw.request("put", keys[:4], keys[:3])
    with pytest.raises(ValueError, match="no vals"):
        tw.request("get", keys[:4], keys[:4])
    with pytest.raises(ValueError, match="unknown op"):
        tw.request("scan", keys[:4])
    t = tw.request("put", keys[:4], keys[:4] ^ np.uint64(7))  # the forming state is intact
    (rep,) = tw.drain()
    assert rep.ticket == t and rep.status == ADMIT_OK
    assert (np.asarray(rep.result) >= 0).all()


def test_oversized_batch_chunks_across_waves():
    keys, vals = _single_world()
    tw = Twin(keys, vals, wave_size=16)
    t = tw.request("get", keys[:100])
    assert tw.drv.seals["size"] == 6  # six full 16-row waves; the tail seals on drain
    (rep,) = tw.drain()
    assert tw.drv.waves_formed == 7
    got_vals, found = rep.result
    assert rep.ticket == t
    assert found.all() and np.array_equal(got_vals, vals[:100])


def test_tickets_monotonic_across_drains():
    keys, vals = _single_world()
    tw = Twin(keys, vals, wave_size=32)
    t1 = tw.request("get", keys[:8])
    t2 = tw.request("get", keys[8:16])
    assert {r.ticket for r in tw.drain()} == {t1, t2}
    t3 = tw.request("get", keys[16:24])
    assert t3 > t2 > t1
    second = {r.ticket: r for r in tw.drain()}
    assert set(second) == {t3}
    v3, f3 = second[t3].result
    assert f3.all() and np.array_equal(v3, vals[16:24])


def test_deadline_seals_without_further_requests():
    keys, vals = _single_world()
    tw = Twin(keys, vals, wave_size=256, max_delay=3)
    tw.request("get", keys[:4])
    assert tw.drv.inflight_waves == 0  # far below wave_size: still forming
    assert tw.tick() == 0
    assert tw.tick() == 0
    assert tw.tick() == 1  # the oldest waited max_delay ticks -> seals
    assert tw.drv.inflight_waves == 1 and tw.drv.seals["deadline"] == 1
    (rep,) = tw.drain()
    assert rep.status == ADMIT_OK and rep.result[1].all()
    assert tw.tick(10) == 0  # a quiet scheduler never seals


def test_admission_retry_is_lossless_under_resubmission():
    keys, vals = _single_world()
    tw = Twin(keys, vals, admission_policies={5: dict(rate=4.0, burst=16.0)}, wave_size=64,
              tenant_bits=keymod.TENANT_BITS)
    lk = np.arange(100, 110, dtype=np.uint64)  # 10-key requests
    t1 = tw.request("put", lk, lk * np.uint64(3), tenant=5)  # bucket 16 -> 6
    t2 = tw.request("put", lk, lk * np.uint64(9), tenant=5)  # 10 > 6 -> RETRY
    by = {r.ticket: r for r in tw.drain()}
    assert by[t1].status == ADMIT_OK
    assert by[t2].status == ADMIT_RETRY and by[t2].result is None
    tg = tw.request("get", lk, tenant=5)  # still over budget
    assert {r.ticket: r for r in tw.drain()}[tg].status == ADMIT_RETRY
    tw.tick()  # +4 tokens -> 10: enough only if no refusal took tokens
    t3 = tw.request("get", lk, tenant=5)
    by = {r.ticket: r for r in tw.drain()}
    assert by[t3].status == ADMIT_OK
    got, found = by[t3].result
    assert found.all() and np.array_equal(got, lk * np.uint64(3))  # t2 never landed
    tw.tick(3)
    t4 = tw.request("put", lk, lk * np.uint64(9), tenant=5)
    tw.tick(3)
    t5 = tw.request("get", lk, tenant=5)
    by = {r.ticket: r for r in tw.drain()}
    assert by[t4].status == ADMIT_OK and by[t5].status == ADMIT_OK
    got, found = by[t5].result
    assert found.all() and np.array_equal(got, lk * np.uint64(9))
    s = tw.drv.admission.summary()[5]
    assert s["retried_requests"] == 2 and s["admitted_requests"] == 4


def test_weighted_fair_wave_packing():
    """Weights 1:3 split a contended 64-row wave 16 + 48 (FIFO within each
    tenant), and nobody is starved."""
    oracle, locals_, ek, ev = _tenant_world(n_tenants=2)
    tw = Twin(ek, ev, admission_policies={0: dict(weight=1.0), 1: dict(weight=3.0)}, wave_size=64,
              tenant_bits=keymod.TENANT_BITS)
    l0, l1 = locals_[0][:60], locals_[1][:60]
    ta = tw.request("get", l0, tenant=0)
    tb = tw.request("get", l1, tenant=1)  # 120 rows >= 64 -> seals one wave
    assert tw.drv.inflight_waves == 1
    for drv in (tw.drv, tw.ref):
        comp = {}
        for req, _, k in drv._inflight[0].segments:
            comp[req.tenant] = comp.get(req.tenant, 0) + k
        assert comp == {0: 16, 1: 48}, comp
    by = {r.ticket: r for r in tw.drain()}
    for t, tk, lk in ((0, ta, l0), (1, tb, l1)):
        got, found = by[tk].result
        assert found.all()
        np.testing.assert_array_equal(got, np.array([oracle[t][k] for k in lk.tolist()], dtype=np.uint64))


def test_empty_request_completes_immediately():
    keys, vals = _single_world()
    tw = Twin(keys, vals, wave_size=16)
    t = tw.request("get", np.array([], dtype=np.uint64))
    (rep,) = tw.drain()
    assert rep.ticket == t and rep.status == ADMIT_OK
    got, found = rep.result
    assert got.size == 0 and found.size == 0
    assert tw.drv.waves_formed == 0


def test_tenant_slabs_equal_the_reference_launchers_encoding():
    """``serve.tenant_slabs`` == ``serve_kv_tenants``' own construction
    (``np.unique(keys >> bits)`` dealt round-robin, encoded, sorted)."""
    base = np.sort(np.random.default_rng(9).integers(0, 2**64 - 1, 5000, dtype=np.uint64))
    base[1::7] = base[::7][: base[1::7].size]  # keys equal after the shift
    u = np.unique(base >> np.uint64(keymod.TENANT_BITS))
    want = np.sort(np.concatenate([jkeys.encode_tenant(t, u[t::4]) for t in range(4)]))
    for keys in (np.sort(base), base):  # sorted, as the datasets are, and not
        local, ek, ev = serve.tenant_slabs(keys, 4)
        np.testing.assert_array_equal(ek, want)
        np.testing.assert_array_equal(ev, want ^ np.uint64(0xC0FFEE))
        for t in range(4):
            np.testing.assert_array_equal(local[t], u[t::4])
    assert serve.tenant_slabs(base[:0], 4)[1].size == 0


def test_mixed_stream_of_the_launcher_equals_the_reference():
    """The launcher's 4-tenant request mix (GET, PUT with repeats, RANGE),
    with the documented admission and deadline settings at a small wave:
    every reply and the scheduler summary equal the reference's."""
    local, ek, ev = serve.tenant_slabs(np.sort(np.random.default_rng(8).integers(1, 2**63, 3000, dtype=np.uint64)), 4)
    tw = Twin(ek, ev, admission_policies={0: dict(rate=6.0, weight=0.5)}, wave_size=32, max_delay=4,
              tenant_bits=keymod.TENANT_BITS)
    rng = np.random.default_rng(0)
    weights = serve.tenant_weights(4)
    retries = 0
    for w in range(16):
        for _ in range(4):
            op, t, q, v = serve.tenant_request(rng, local, weights, 32, w)
            if op == "range":
                tw.request("range", q, limit=10, tenant=t)
            else:
                tw.request(op, q, v, tenant=t)
        tw.tick()
        if (w + 1) % 4 == 0:
            retries += sum(r.status == ADMIT_RETRY for r in tw.drain())
    tw.drain()
    s = tw.drv.scheduler_summary()
    assert s["leaked_rows"] == 0 and s["seals"]["kind"] > 0 and retries > 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _serve(capsys, *argv):
    serve.main([*argv, "--device", "cpu"])
    return capsys.readouterr().out


def test_serve_kv_runs_and_reports(capsys):
    out = _serve(capsys, "--kv", "--n-keys", "20000", "--waves", "8")
    assert "queue_depth=2 waves=8" in out and "kOPS on the CPU" in out and "host roofline" in out


def test_serve_kv_versioned_ttl_matches_its_snapshot(capsys, tmp_path):
    out = _serve(capsys, "--kv", "--n-keys", "20000", "--waves", "16", "--retain-epochs", "64", "--ttl", "4",
                 "--profile-dir", str(tmp_path))
    assert "expired keys physically reclaimed" in out
    assert "-> bitwise match (retain_epochs=64)" in out
    assert (tmp_path / "kv.pt.trace.json").is_file()


def test_serve_kv_four_tenants_leaks_nothing(capsys):
    out = _serve(capsys, "--kv", "--n-keys", "20000", "--tenants", "4", "--tenant-rate", "0:2048",
                 "--tenant-weights", "0:0.5", "--max-delay", "4")
    assert "cross-tenant leaks=0 (must be 0)" in out
    assert out.count("[serve-kv]   tenant ") == 4


@pytest.mark.parametrize(
    "argv, item",
    [
        (["--kv", "--partition", "hash"], "item 8"),
        (["--kv", "--partition", "range"], "item 8"),
        (["--kv", "--shards", "4"], "item 8"),
        (["--kv", "--replication", "2"], "item 8"),
        (["--kv", "--kill-primary-at", "8"], "item 8"),
        (["--kv", "--rebalance"], "item 8"),
        (["--kv", "--rebalance-every", "4"], "item 8"),
        (["--kv", "--reshard-to", "4"], "item 8"),
        (["--kv", "--snapshot-dir", "snap"], "item 8"),
        (["--arch", "glm4-9b", "--reduced", "--steps", "16"], "item 11"),
        ([], "item 11"),
    ],
)
def test_serve_refuses_unported_options(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        serve.main([*argv, "--device", "cpu"])


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--kv", "--n-keys", "2000", "--waves", "1"])
