"""The port's example twins (``examples/torch_*.py``) run on the CPU.

Each runs as a user runs it, with ``--device cpu`` and small sizes where the
example takes them, and its own assertions hold; the printed lines are the
reference example's.  ``torch_train_lm.py`` also resumes from a checkpoint
the port's ``CheckpointManager`` wrote.
"""

import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    return runpy.run_path(str(ROOT / "examples" / name))


def test_torch_quickstart_on_the_cpu(capsys):
    _example("torch_quickstart.py")["main"](["--device", "cpu"])
    out = capsys.readouterr().out
    assert "tree depth" in out and "on cpu" in out
    assert "GET: 1000/1000 correct" in out
    assert "RANGE: ordered scans correct across leaf boundaries" in out
    assert "DELETE: tombstones hide keys immediately" in out


def test_torch_paged_decode_on_the_cpu(capsys):
    _example("torch_paged_decode.py")["main"](["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("paged-vs-dense max err") == 3
    assert "released seq 202: 3 blocks returned to the pool" in out


def test_torch_train_lm_on_the_cpu_and_resumed(tmp_path, capsys):
    """Two steps from scratch (the loss falls on the second batch of the
    stream), then a run resumed from a checkpoint written at step 1."""
    ex = _example("torch_train_lm.py")
    argv = ["--steps", "2", "--batch", "2", "--seq", "64", "--device", "cpu"]
    ex["main"](argv + ["--ckpt", str(tmp_path / "fresh")])
    out = capsys.readouterr().out
    assert "model: glm4-100m, 63M params on cpu" in out
    losses = [float(line.split("loss ")[1].split()[0]) for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.training import optimizer, train_step as ts

    cfg = ex["hundred_m"]()
    tcfg = ts.TrainConfig(opt=optimizer.OptConfig(lr=6e-4), microbatches=2)
    CheckpointManager(tmp_path / "resume").save(1, ts.init_state(cfg, tcfg, 0, device="cpu"), blocking=True)
    ex["main"](argv + ["--ckpt", str(tmp_path / "resume")])
    out = capsys.readouterr().out
    assert "resumed from step 1" in out
    assert [line.split()[1] for line in out.splitlines() if line.startswith("step")] == ["1"]


@pytest.mark.parametrize("name", ["torch_quickstart.py", "torch_paged_decode.py", "torch_train_lm.py"])
def test_example_twins_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name)["main"]([])
