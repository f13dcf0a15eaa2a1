"""Dry run of the DPA-Store service on the production meshes, one rank for
real (the port of the JAX package's ``launch/kv_dryrun.py``).

The reference lowers and compiles the ``shard_map`` request wave (hash
routing -> all_to_all -> local learned-index GET -> all_to_all back) for
256 and 512 devices that are not there.  Torch has nothing that lowers a
program for devices it does not have, so this runs ONE rank's wave for
real at the production per-shard size instead: ``n_shards`` = the
production mesh's ``data`` axis (16 on both meshes), one shard of
``n_keys // n_shards`` keys (3,125,000 at the service's 50M) bulk-loaded
from ``datasets.sparse(seed)``, ``SVC.wave_size // n_shards`` = 4096
requests with ``cap`` = 4096, through ``kvshard.make_serve_wave``'s body
(B1 once a wave: the body ``serve_wave_sharded`` runs on every rank).  The
exchange is a loopback that returns its input and counts the bytes each
all-to-all would hand over, so every bucket is served by this shard: the
same lane count and live requests as a rank of the real mesh.

    PYTHONPATH=src python -m repro_torch.launch.kv_dryrun --mesh both      # on the card
    PYTHONPATH=src python -m repro_torch.launch.kv_dryrun --device cpu --n-keys 20000

Each mesh writes ``dpastore-service__wave__{pod16x16,pod2x16x16}.json``
under ``--out`` (default ``build/dryrun`` of the checkout) with the
reference's keys where they mean the same, ``memory`` as the device's peak
allocation, and the wave's milliseconds; there is no lowering or compile
time.  Every answer is checked against the shard's keys.
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..configs.dpastore_service import CONFIG as SVC
from ..core import datasets
from ..core.keys import limbs_to_tensor, split_u64
from ..core.store import DPAStore
from ..device import resolve_device
from ..core.tree import TreeConfig
from ..distributed import kvshard
from ..kernels import build
from .mesh import production_mesh_shape

RESULTS = Path(__file__).resolve().parents[3] / "build" / "dryrun"
VALUE_SALT = np.uint64(0x5DEECE66D)
REPS = 5  # timed waves after one warm-up


class LoopbackExchange:
    """Stands in for the all-to-all of a mesh that is not here: returns
    ``x`` and counts the calls and the bytes each would hand over (the whole
    ``(n_shards, cap)`` tensor)."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        self.bytes += x.numel() * x.element_size()
        return x


def _write(out_dir: Path, cell: str, rec: dict):
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell}.json").write_text(json.dumps(rec, indent=1, default=str))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(multi_pod: bool, out_dir: Path, *, device=None, n_keys: int = SVC.n_keys, seed: int = 0) -> dict:
    """One mesh's record: a shard of ``n_keys // n_shards`` keys, one
    rank's wave timed ``REPS`` times after a warm-up."""
    dev = resolve_device(device)
    shape, axes = production_mesh_shape(multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    n_shards = shape[axes.index("data")]
    keys_per_shard = n_keys // n_shards
    wave_local = SVC.wave_size // n_shards
    cap = wave_local  # ample capacity: no overflow in the dry run
    if dev.type == "cuda":  # the peak of this run alone: an earlier run's store is gone
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    keys = datasets.sparse(keys_per_shard, seed=seed)
    st = DPAStore(keys, keys ^ VALUE_SALT, TreeConfig(eps_inner=SVC.eps_inner, eps_leaf=SVC.eps_leaf),
                  cache_cfg=None, scan_cache_cfg=None, device=dev)
    _sync(dev)
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 1)
    q = np.concatenate([rng.choice(keys, wave_local * 3 // 4),
                        rng.integers(0, 2**64 - 1, wave_local - wave_local * 3 // 4, dtype=np.uint64)])
    lq = limbs_to_tensor(split_u64(q), dev)
    khi, klo = lq[:, 0].contiguous(), lq[:, 1].contiguous()
    body = kvshard.make_serve_wave(n_shards, cap, depth=st.depth, eps_inner=SVC.eps_inner, eps_leaf=SVC.eps_leaf)
    body(st.tree, st.ib, khi, klo, LoopbackExchange())  # warm-up
    build.reset_launches()
    times, exchanges = [], []
    for _ in range(REPS):
        x = LoopbackExchange()
        _sync(dev)
        t = time.perf_counter()
        vhi, vlo, found, ok = body(st.tree, st.ib, khi, klo, x)
        _sync(dev)
        times.append((time.perf_counter() - t) * 1e3)
        exchanges.append((x.calls, x.bytes))
    assert len(set(exchanges)) == 1, exchanges
    calls, nbytes = exchanges[0]
    # every request landed, and the shard answered it as its keys say
    vals = (vhi.cpu().numpy().view(np.uint32).astype(np.uint64) << np.uint64(32)) | vlo.cpu().numpy().view(np.uint32)
    fd, okm = found.cpu().numpy(), ok.cpu().numpy()
    want = np.isin(q, keys)
    if not (okm.all() and np.array_equal(fd, want) and np.array_equal(vals[fd], q[fd] ^ VALUE_SALT)):
        raise AssertionError(f"{mesh_name}: the shard's answers differ from its keys")
    rec = {
        "arch": SVC.name, "shape": f"wave{SVC.wave_size}", "mesh": mesh_name, "supported": True,
        "mesh_shape": list(shape), "mesh_axes": list(axes), "n_shards": n_shards,
        "keys_per_shard": keys_per_shard, "wave_local": wave_local, "cap": cap, "depth": st.depth, "seed": seed,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "status": "ok",
        "params_total": n_keys * 16, "params_active": n_keys * 16, "tokens": SVC.wave_size,
        "collectives": {"all-to-all": {"count": calls, "bytes": nbytes}},
        "collective_bytes_per_device": nbytes,
        "memory": {
            "state_bytes": sum(t.numel() * t.element_size() for t in (*st.tree, *st.ib)),
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        },
        "load_s": load_s, "wave_ms": float(np.median(times)), "wave_ms_all": times,
        "launches": {"get": build.launches["get"]}, "requests": int(q.size), "found": int(fd.sum()),
    }
    cell = f"dpastore-service__wave__{mesh_name}"
    _write(out_dir, cell, rec)
    peak = rec["memory"]["peak_bytes"]
    print(
        f"[kv-dryrun] {cell}: OK wave={rec['wave_ms']:.3f}ms coll/dev={nbytes / 2**20:.2f}MiB "
        f"mem={'n/a' if peak is None else f'{peak / 2**20:.1f}MiB'} on {rec['device']}",
        flush=True,
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--device", default=None, help="default: the card (raises without CUDA); 'cpu' runs plain torch")
    ap.add_argument("--n-keys", type=int, default=SVC.n_keys, help="keys of the whole service (default: 50M)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = Path(args.out)
    kw = dict(device=args.device, n_keys=args.n_keys, seed=args.seed)
    if args.mesh in ("single", "both"):
        run(False, out, **kw)
    if args.mesh in ("multi", "both"):
        run(True, out, **kw)


if __name__ == "__main__":
    main()
