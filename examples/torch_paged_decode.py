"""LM decode with the port's learned-index paged KV cache — the paper's
technique serving a model.

    PYTHONPATH=src python examples/torch_paged_decode.py
    PYTHONPATH=src python examples/torch_paged_decode.py --device cpu

The PyTorch twin of ``examples/paged_decode.py``: the same steps, prints and
checks, plus ``--device`` (the CUDA card unless ``cpu`` is given; without
CUDA the cache raises).  Three sequences decode in interleaved order; every
attention call routes through the DPA-Store page table: block allocation =
INSERT, cache fetch = ordered RANGE + the paged-gather kernel.  The
dense-cache result is computed side by side and asserted equal.
"""

import argparse

import numpy as np
import torch

from repro_torch.models.layers import decode_attention
from repro_torch.serving.engine import PagedAttentionLayer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="the CUDA card unless given; 'cpu' runs the plain-torch path")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    H, HKV, HD = 4, 2, 16
    layer = PagedAttentionLayer(kv_heads=HKV, head_dim=HD, block_size=8, n_blocks=128, device=args.device)
    dev = layer.cache.device
    dense = {}

    seqs = {101: 37, 202: 23, 303: 41}
    print(f"decoding {len(seqs)} sequences, lengths {list(seqs.values())} on {dev}")
    for t in range(max(seqs.values())):
        for sid, n in seqs.items():
            if t >= n:
                continue
            k = torch.from_numpy(rng.normal(size=(HKV, HD)).astype(np.float32)).to(dev)
            v = torch.from_numpy(rng.normal(size=(HKV, HD)).astype(np.float32)).to(dev)
            layer.append(sid, k, v)
            dense.setdefault(sid, []).append((k, v))

    worst = 0.0
    for sid, n in seqs.items():
        q = torch.from_numpy(rng.normal(size=(H, HD)).astype(np.float32)).to(dev)
        out_paged = layer.attend(sid, q)
        K = torch.stack([kv[0] for kv in dense[sid]])[None]
        V = torch.stack([kv[1] for kv in dense[sid]])[None]
        out_dense = decode_attention(q[None, None], K, V, n)[0, 0]
        err = float(torch.max(torch.abs(out_paged.float() - out_dense)))
        worst = max(worst, err)
        print(f"seq {sid}: {n} tokens, {len(layer.cache.lookup_slots(sid))} blocks, "
              f"paged-vs-dense max err {err:.2e}")
    assert worst < 1e-2
    st = layer.cache.table.stats
    print(f"page-table store: {st.puts} INSERTs, {st.ranges} RANGEs, "
          f"{st.patches_structural + st.patches_update} patches — the paper's "
          f"machinery doing the serving bookkeeping")
    # free one sequence, reuse its blocks
    freed = layer.cache.release(202)
    print(f"released seq 202: {freed} blocks returned to the pool")


if __name__ == "__main__":
    main()
