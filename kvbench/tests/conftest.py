"""The benchmark's own tests: ``python -m pytest -q kvbench/tests`` from the
repository root.  The program is imported from ``src``; the tests that need
a CUDA card carry the ``cuda`` marker and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the CPU size of every cell: the same loop, mix and comparison, tiny
TINY = {
    "config": {"records": 20000, "wave_size": 512},
    "traffic": {"stream_groups": 6, "warmup_groups": 1, "check_groups": 4, "profile_seconds": 0.05},
}
CELLS = ("ycsb-c.50M", "ycsb-b.50M-hash4", "ycsb-e.50M")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
