"""Serve the port's DPA-Store as a KV service under the paper's YCSB-style mixes.

    PYTHONPATH=src python examples/torch_kv_serve.py --workload B --waves 12
    PYTHONPATH=src python examples/torch_kv_serve.py --workload E --device cpu

The PyTorch twin of ``examples/kv_serve.py``: the same mixes A-E and flags,
plus ``--device`` (the CUDA card unless ``cpu`` is given; without CUDA the
store raises).  It shows the request path end to end on the port's
``DPAStore``: client-side key hashing (steering), the hot-entry cache
(kernel B2), the learned traversal (B1), insert-buffer writes, RANGE scans
(B3) and the patch/stitch cycle, with per-wave stats.
"""

import argparse
import time

import numpy as np

from repro_torch.core import DPAStore, TreeConfig
from repro_torch.core.datasets import sparse, zipf_indices
from repro_torch.kernels import build

MIXES = {
    "A": {"get": 0.5, "update": 0.5},
    "B": {"get": 0.95, "update": 0.05},
    "C": {"get": 1.0},
    "D": {"get": 0.95, "insert": 0.05},
    "E": {"range": 0.95, "insert": 0.05},
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=sorted(MIXES), default="B")
    ap.add_argument("--n-keys", type=int, default=100_000)
    ap.add_argument("--waves", type=int, default=12)
    ap.add_argument("--wave-size", type=int, default=2048)
    ap.add_argument("--zipf", type=float, default=0.99)
    ap.add_argument("--device", default=None, help="the CUDA card unless given; 'cpu' runs the plain-torch path")
    args = ap.parse_args(argv)

    keys = sparse(args.n_keys, seed=3)
    store = DPAStore(keys, keys ^ np.uint64(7), TreeConfig(), device=args.device)
    mix = MIXES[args.workload]
    rng = np.random.default_rng(1)
    idx = zipf_indices(args.n_keys, args.waves * args.wave_size, args.zipf, seed=4)

    print(f"workload {args.workload} {mix} over {args.n_keys:,} keys on {store.device}")
    build.reset_launches()
    t0 = time.time()
    for w in range(args.waves):
        base = keys[idx[w * args.wave_size : (w + 1) * args.wave_size]]
        ptr = 0
        for op, frac in mix.items():
            k = int(args.wave_size * frac)
            ks = base[ptr : ptr + k]
            ptr += k
            if op == "get":
                _, found = store.get(ks)
                assert found.all()
            elif op == "update":
                store.put(ks, ks + np.uint64(w))
            elif op == "insert":
                nk = rng.integers(0, 2**63, k, dtype=np.uint64)
                store.put(nk, nk)
            elif op == "range":
                store.range(ks[:128], limit=10)
        s = store.stats
        print(
            f"wave {w:3d}: cache_hit={s.cache_hits}/{s.cache_probes} "
            f"patches={s.patches_structural}+{s.patches_update} "
            f"stitchedKB={s.stitched_dpa_bytes//1024}"
        )
    dt = time.time() - t0
    n = args.waves * args.wave_size
    print(f"{n} ops in {dt:.2f}s = {n/dt/1e3:.1f} kOPS on {store.device}; kernel launches {dict(build.launches)}")


if __name__ == "__main__":
    main()
