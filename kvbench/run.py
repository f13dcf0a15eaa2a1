"""Run one cell of the benchmark on the CUDA card and print its result.

    python3 kvbench/run.py --workload ycsb-c.50M --seed 7 --seconds 20 --trace 0

(``python3 -m kvbench.run`` does the same.)  The last line of standard
output is the result object; the compared numbers and their limits are the
last lines of standard error.  Without a CUDA card, with fewer cards than
the cell asks for, or without the program's ``src/repro_torch`` beside this
directory, the run exits with a code other than 0 and prints no result.
"""

from __future__ import annotations

import time

T_ENTRY = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# run as a script, this directory heads sys.path: its modules (trace, check,
# ...) would shadow top-level modules of those names
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)

import argparse  # noqa: E402
import json  # noqa: E402


def since_process_start() -> float:
    """Seconds from this process's start to ``T_ENTRY`` (interpreter start
    and the first imports), read from ``/proc``; 0 where it cannot be."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return max(0.0, age - (time.perf_counter() - T_ENTRY))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: report the per-layer metrics")
    ap.add_argument("--control", default=None, help="run the control with this fault (value32, stale) instead of the program")
    args = ap.parse_args(argv)
    t_start = T_ENTRY - since_process_start()

    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from kvbench import guard

    guard.require_clean("at start")
    import torch

    from kvbench import harness

    manifest = harness.load_manifest(ROOT)
    cell = harness.find_cell(manifest, args.workload)
    if not torch.cuda.is_available():
        print("kvbench: no CUDA device; the benchmark measures the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"kvbench: {args.workload} needs {cell['chips']} cards, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("kvbench: src/repro_torch not found beside kvbench/", file=sys.stderr)
        return 2
    out = harness.run_cell(
        args.workload,
        args.seed,
        args.seconds,
        bool(args.trace),
        device="cuda",
        t_start=t_start,
        manifest=manifest,
        control=args.control,
        log=lambda s: print(s, flush=True),
    )
    guard.require_clean("before the result")
    for name, c in out["check"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
