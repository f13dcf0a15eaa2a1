"""Quickstart: the port's DPA-Store in 60 seconds.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The PyTorch twin of ``examples/quickstart.py``: the same steps, prints and
checks, plus ``--device`` (the CUDA card unless ``cpu`` is given; without
CUDA the store raises).  It builds the learned-index KV store (the paper's
system), runs the full op mix — GET through the cache probe and traversal
kernels, RANGE through the leaf-chain scan — and shows the update cycle
(insert buffers -> host patch -> stitch) doing its thing.
"""

import argparse

import numpy as np

from repro_torch.core import DPAStore, TreeConfig
from repro_torch.core.datasets import sparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="the CUDA card unless given; 'cpu' runs the plain-torch path")
    args = ap.parse_args(argv)

    # ---- bulk load (Sec 3.2.4) --------------------------------------------
    keys = sparse(100_000, seed=0)
    vals = keys ^ np.uint64(0xFEED)
    store = DPAStore(keys, vals, TreeConfig(eps_inner=4, eps_leaf=8), device=args.device)
    print(f"bulk-loaded {len(keys):,} pairs: tree depth {store.depth}, "
          f"{(store.image.leaf_count > 0).sum()} leaves, "
          f"{store.stats.bulk_load_dpa_bytes/1e6:.1f} MB stitched to 'DPA memory' on {store.device}")

    # ---- GET (traversal + hot cache) --------------------------------------
    q = np.random.default_rng(1).choice(keys, 1000)
    got, found = store.get(q)
    assert found.all() and (got == (q ^ np.uint64(0xFEED))).all()
    print(f"GET: 1000/1000 correct (cache hits so far: {store.stats.cache_hits})")

    # ---- INSERT (buffers -> patch -> stitch) -------------------------------
    new = np.setdiff1d(
        np.random.default_rng(2).integers(0, 2**63, 5000, dtype=np.uint64), keys
    )
    store.put(new, new)
    v, f = store.get(new[:500])
    assert f.all() and (v == new[:500]).all()
    print(f"INSERT: {len(new)} new keys visible immediately "
          f"({store.stats.patches_structural} structural patches, "
          f"{store.stats.new_leaves} new leaves stitched)")

    # ---- RANGE (ordered scan) ----------------------------------------------
    res = store.range(keys[:4], limit=10)  # RangeResult: named fields
    rk, rv, cnt = res  # ...that still unpacks like the legacy tuple
    all_k, _ = store.items()
    for i in range(4):
        expect = all_k[all_k >= keys[i]][:10]
        assert res.counts[i] == expect.size
        assert np.array_equal(res.keys[i][: cnt[i]], expect)
    print("RANGE: ordered scans correct across leaf boundaries")

    # ---- DELETE + consistency ----------------------------------------------
    store.delete(new[:100])
    _, f = store.get(new[:100])
    assert not f.any()
    print("DELETE: tombstones hide keys immediately; patch reclaims later")
    print(f"final stats: {store.stats}")


if __name__ == "__main__":
    main()
