"""A tiny closed-loop drive of each cell through the port's plain-torch path
on the CPU, the faults the comparison must catch, the control, a cell added
as files alone, the import check, and the refusal without a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kvbench import control, guard, harness, trace
from kvbench.tests.conftest import CELLS, TINY

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**35 + 17


def drive(cell, traced=False, seed=SEED, **kw):
    return harness.run_cell(cell, seed, 0.3, traced, device="cpu", overrides=TINY, log=lambda s: None, **kw)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_each_cell_runs_correct_on_the_cpu(cell, traced):
    out = drive(cell, traced)
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "check" and all(c["limit"] == 0 for c in out["check"].values())
    wanted = {m["name"] for m in harness.metrics_of(harness.load_manifest(), cell, traced)}
    device_only = {"launches_per_kop", "get_roofline", "scan_roofline", "device_idle"}
    assert set(out["metrics"]) == wanted - device_only
    if not traced:
        assert out["metrics"]["mops"]["value"] > 0 and out["metrics"]["setup_s"]["value"] > 0
    json.dumps(out)


# --- faults planted under the timed path --------------------------------------


def _drop_writes(monkeypatch):
    """A write that returns its state unchanged: acknowledged, never applied."""
    from repro_torch.core import store as st

    import torch

    def write_issue(self, op, keys, vals=None):
        return st._WriteWave(n=len(keys), status=torch.zeros(len(keys), dtype=torch.int32))

    monkeypatch.setattr(st.DPAStore, "write_issue", write_issue)
    monkeypatch.setattr(st.DPAStore, "put", lambda self, keys, vals, **kw: np.zeros(len(keys), dtype=np.int32))


def _half_batch(monkeypatch):
    """Half of each wave left out: its second half answers nothing."""
    from repro_torch.core import store as st

    get_fin, range_fin = st.DPAStore.get_finalize, st.DPAStore.range_finalize

    def get_finalize(self, w):
        v, f = get_fin(self, w)
        h = v.size // 2
        v[h:], f[h:] = 0, False
        return v, f

    def range_finalize(self, w):
        r = range_fin(self, w)
        r.counts[r.counts.size // 2 :] = 0
        return r

    monkeypatch.setattr(st.DPAStore, "get_finalize", get_finalize)
    monkeypatch.setattr(st.DPAStore, "range_finalize", range_finalize)


def _altered_answer(monkeypatch):
    """One answer altered where it is produced."""
    from repro_torch.core import store as st

    get_fin, range_fin = st.DPAStore.get_finalize, st.DPAStore.range_finalize

    def get_finalize(self, w):
        v, f = get_fin(self, w)
        v[0] ^= np.uint64(1)
        return v, f

    def range_finalize(self, w):
        r = range_fin(self, w)
        r.vals[0, 0] ^= np.uint64(1)
        return r

    monkeypatch.setattr(st.DPAStore, "get_finalize", get_finalize)
    monkeypatch.setattr(st.DPAStore, "range_finalize", range_finalize)


def _shard_left_out(monkeypatch):
    """The sharded facade leaves one shard's part of each GET wave out."""
    from repro_torch.distributed import kvshard

    fin = kvshard.ShardedDPAStore.get_finalize

    def get_finalize(self, w):
        return fin(self, w._replace(parts=w.parts[:-1]))

    monkeypatch.setattr(kvshard.ShardedDPAStore, "get_finalize", get_finalize)


FAULTS = [
    ("ycsb-b.50M-hash4", _drop_writes, "readback_wrong"),
    ("ycsb-e.50M", _drop_writes, "readback_wrong"),
    ("ycsb-c.50M", _half_batch, "get_wrong"),
    ("ycsb-b.50M-hash4", _half_batch, "get_wrong"),
    ("ycsb-e.50M", _half_batch, "scan_wrong"),
    ("ycsb-c.50M", _altered_answer, "get_wrong"),
    ("ycsb-b.50M-hash4", _altered_answer, "get_wrong"),
    ("ycsb-e.50M", _altered_answer, "scan_wrong"),
    ("ycsb-b.50M-hash4", _shard_left_out, "get_wrong"),
]


@pytest.mark.parametrize("cell,plant,number", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_a_planted_fault_comes_out_not_correct(monkeypatch, cell, plant, number):
    plant(monkeypatch)
    out = drive(cell)
    assert out["correct"] is False and out["check"][number]["value"] > 0


@pytest.mark.parametrize(
    "cell,fault",
    [(c, "value32") for c in CELLS] + [("ycsb-b.50M-hash4", "stale"), ("ycsb-e.50M", "stale")],
)
def test_the_control_comes_out_not_correct(cell, fault):
    out = drive(cell, control=fault)
    assert out["correct"] is False and max(c["value"] for c in out["check"].values()) > 0


def test_a_control_of_another_name_is_refused():
    with pytest.raises(ValueError):
        control.ControlStore(np.arange(3, dtype=np.uint64), np.arange(3, dtype=np.uint64), "lossy")


# --- data-driven --------------------------------------------------------------


def test_a_cell_added_as_files_alone_is_found_and_runs(tmp_path):
    base = tmp_path / "kvbench"
    shutil.copytree(ROOT / "kvbench", base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    tr = {
        "name": "ycsb-a",
        "source": "YCSB core workload A: readproportion=0.5, updateproportion=0.5, zipfian",
        "mix": {"read": 0.5, "update": 0.5},
        "request_distribution": "zipfian",
        "zipfian_constant": 0.99,
        "stream_groups": 6,
    }
    (base / "traffic" / "ycsb-a.json").write_text(json.dumps(tr))
    m["workloads"].append({"name": "ycsb-a.50M", "config": "ycsb-50M", "traffic": "ycsb-a", "chips": 1,
                           "why": "YCSB-A, half zipf updates"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    out = harness.run_cell("ycsb-a.50M", SEED, 0.3, False, device="cpu", base=base, overrides=TINY,
                           log=lambda s: None)
    assert out["correct"] is True and set(out["check"]) == {"get_wrong", "readback_wrong"}


# --- the import check ------------------------------------------------------------


def test_the_import_check_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["repro_torch", "repro_torch.core.store", "numpy", "reprox"]) == []
    assert guard.forbidden_loaded(["repro.core", "jax.numpy", "jaxlib", "flax.linen", "benchmarks.run"]) == [
        "benchmarks", "flax", "jax", "jaxlib", "repro"]


def _modules_after(code):
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; print(json.dumps(sorted(sys.modules)))"],
                         env=env, capture_output=True, text=True, check=True, cwd=ROOT)
    return json.loads(out.stdout.splitlines()[-1])


def test_the_harness_and_the_program_load_no_jax():
    mods = _modules_after(
        "from kvbench import harness, check, control, traffic, trace\n"
        "import repro_torch.serving.pipeline, repro_torch.distributed.kvshard, repro_torch.core"
    )
    assert guard.forbidden_loaded(mods) == []


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules_after("import kvbench.reference, kvbench.check, kvbench.control")
    assert not [m for m in mods if m.split(".")[0] in ("repro_torch", "repro", "jax")]


# --- refusals ------------------------------------------------------------------


def _run(args, cwd):
    return subprocess.run([sys.executable, "kvbench/run.py", *args], cwd=cwd, capture_output=True, text=True)


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = _run(["--workload", "ycsb-c.50M", "--seed", "1", "--seconds", "1", "--trace", "0"], ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_refuses_an_unknown_cell(tmp_path):
    r = _run(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1", "--trace", "0"], ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


# --- the trace reduction ----------------------------------------------------------


def test_the_trace_reduction_on_a_synthetic_trace():
    X = lambda cat, name, ts, dur, **kw: dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=kw.pop("tid", 1), **kw)  # noqa: E731
    ev = [
        X("user_annotation", trace.SLICE, 100, 1000),
        X("user_annotation", "kv/get/issue#3", 110, 200),
        X("user_annotation", "kv/put/issue#4", 400, 400),
        X("user_annotation", "kv/get/drain#3", 450, 100),  # drained inside the put's issue
        X("cpu_op", "aten::copy_", 460, 50),
        X("cuda_runtime", "cudaLaunchKernel", 120, 5, args={"correlation": 1}),
        X("cuda_runtime", "cudaMemcpyAsync", 470, 5, args={"correlation": 2}),
        X("cuda_runtime", "cudaLaunchKernel", 600, 5, args={"correlation": 3}),
        X("cuda_runtime", "cudaLaunchKernel", 2000, 5, args={"correlation": 4}),  # after the slice
        X("kernel", "k_get", 130, 100, tid=7, args={"correlation": 1}),
        X("gpu_memcpy", "Memcpy DtoH", 480, 20, tid=7, args={"correlation": 2}),
        X("kernel", "k_put", 610, 90, tid=7, args={"correlation": 3}),
        X("kernel", "k_late", 2010, 90, tid=7, args={"correlation": 4}),
    ]
    s = trace.summarize(ev)
    assert s["window_s"] == pytest.approx(1000e-6) and s["busy_s"] == pytest.approx(210e-6)
    assert s["device_ops"] == 3
    assert s["device_s_by_kind"] == pytest.approx({"read": 120e-6, "write": 90e-6})
    assert s["top_ops"][0] == ["k_get", pytest.approx(100e-6)]
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(790e-6)
    assert "client" in gaps and any(k.startswith("kv/put/issue") for k in gaps)


def test_no_slice_no_summary():
    assert trace.summarize([]) is None


# --- on the card --------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_card_at_a_small_size(card, cell):
    out = harness.run_cell(cell, SEED, 1.0, True, device=card, overrides=TINY, log=lambda s: None)
    assert out["correct"] is True and out["device"]["busy_s"] > 0
    assert {"launches_per_kop", "device_idle"} <= set(out["metrics"])
