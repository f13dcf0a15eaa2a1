"""Run the sharded device waves on ranks spawned on one host.

    outs, ranks = spawn_waves([(stacked_tree, stacked_ib)], cases, device="cpu")

One rank per shard: rank ``r`` takes ``shard_state(tree, ib, r)`` of the
stacked pools and row ``r`` of each case's requests, builds the wave with
``serve_wave_sharded`` or ``range_wave_sharded`` on a ``(n_shards, 1)``
debug mesh, and runs it; the parent stacks the ranks' ``(1, W)`` rows
back into the ``(n_shards, W)`` outputs of the emulated waves.

The ranks are spawned (never forked: the parent may hold CUDA), meet at a
file rendezvous in a temporary directory, and get the pools as spawn
arguments: on the card through CUDA IPC handles (no copy; the ranks share
the parent's card and run ``gloo``, since NCCL puts one rank on a card),
on the CPU through shared memory.  Each rank writes its outputs and a
report (host ms, exchange ms, calls and bytes of each wave, its kernel
launch counts) to that directory.  A rank that fails makes
``spawn_waves`` raise.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class WaveCase:
    """One sharded wave: ``kind`` "serve" (GET) or "range"; ``khi``/``klo``
    ``(n_shards, W)`` int32-held limbs; ``boundaries`` the range tier's
    (None: hash routing, for "serve" only); ``boundaries_prev`` and
    ``epoch_tag`` ``(n_shards, W)`` a mixed-epoch wave; ``state`` the index
    of the stacked pools it runs on; ``params`` the wave's keywords (``cap``,
    ``depth``, ``eps_inner``, ``eps_leaf`` or ``limit``, ``max_leaves``,
    ``fanout``, ``max_rounds``)."""

    kind: str
    khi: torch.Tensor
    klo: torch.Tensor
    params: Dict
    boundaries: Optional[np.ndarray] = None
    boundaries_prev: Optional[np.ndarray] = None
    epoch_tag: Optional[torch.Tensor] = None
    state: int = 0

    def emulated(self, stacked_tree, stacked_ib):
        """The same wave on one device (``serve_wave_emulated`` /
        ``range_wave_emulated``) on tensors on the pools' device."""
        from ..distributed import kvshard, rangeshard

        dev = stacked_tree.root.device
        khi, klo = self.khi.to(dev), self.klo.to(dev)
        tag = None if self.epoch_tag is None else self.epoch_tag.to(dev)
        if self.kind == "serve":
            return kvshard.serve_wave_emulated(
                stacked_tree, stacked_ib, khi, klo, **self.params, epoch_tag=tag, **self._routes()
            )
        return rangeshard.range_wave_emulated(
            stacked_tree, stacked_ib, khi, klo, self.boundaries, **self.params,
            boundaries_prev=self.boundaries_prev, epoch_tag=tag,
        )

    def _routes(self) -> Dict:
        from ..distributed import rangeshard

        route = lambda b: None if b is None else rangeshard.make_route_fn(b)  # noqa: E731
        return {"route_fn": route(self.boundaries), "route_fn_prev": route(self.boundaries_prev)}

    def sharded(self, mesh, stacked_tree, stacked_ib):
        """The rank-local wave function of this case on ``mesh``."""
        from ..distributed import kvshard, rangeshard

        if self.kind == "serve":
            return kvshard.serve_wave_sharded(mesh, stacked_tree, stacked_ib, **self.params, **self._routes())
        return rangeshard.range_wave_sharded(
            mesh, stacked_tree, stacked_ib, self.boundaries, **self.params, boundaries_prev=self.boundaries_prev
        )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_cases(rank, m, dev, states, cases, reps) -> Dict:
    from ..distributed.kvshard import shard_state
    from ..kernels import build
    from . import mesh as meshes

    _, size, coord = meshes.data_axis(m)
    build.reset_launches()
    outs, waves = [], []
    for case in cases:
        stacked_tree, stacked_ib = states[case.state]
        tree, ib = shard_state(stacked_tree, stacked_ib, rank)
        rows = [case.khi[rank : rank + 1].to(dev), case.klo[rank : rank + 1].to(dev)]
        if case.epoch_tag is not None:
            rows.append(case.epoch_tag[rank : rank + 1].to(dev))
        host_ms = []
        for _ in range(reps):
            fn = case.sharded(m, stacked_tree, stacked_ib)
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(tree, ib, *rows)
            _sync(dev)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(tuple(o.cpu() for o in out))
        x = fn.exchange
        waves.append({"host_ms": host_ms, "exchange_ms": x.seconds * 1e3, "exchanges": x.calls, "bytes": x.bytes})
    return {"outputs": outs, "waves": waves, "launches": dict(build.launches),
            "mesh": {"names": list(m.mesh_dim_names), "shape": list(m.shape), "data": [size, coord]}}


def _rank_main(rank, world, rendezvous, device, backend, states, cases, reps, out_dir):
    import gc

    import torch.distributed as dist

    from . import mesh as meshes

    # every rank is on this host: gloo's pairs need no other interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dev = torch.device(device)
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    meshes.init_process_group(rank, world, f"file://{rendezvous}", device=dev, backend=backend)
    try:
        m = meshes.make_debug_mesh(world, 1, device=dev, backend=backend)
        rec = _run_cases(rank, m, dev, states, cases, reps)
        torch.save({**rec, "backend": backend, "device": str(dev)}, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
        # drop this rank's references to the parent's pools (the spawn
        # arguments hold them until the process ends, and a rank ends without
        # running destructors), so the parent can free them: CUDA IPC
        # counts the blocks a rank still maps
        states.clear()
        cases.clear()
        gc.collect()


def spawn_waves(
    states: List[Tuple], cases: List[WaveCase], *, device=None, backend: Optional[str] = None, reps: int = 1,
) -> Tuple[List[Tuple[torch.Tensor, ...]], List[Dict]]:
    """Run ``cases`` on one spawned rank per shard of ``states`` (a list of
    ``(stacked_tree, stacked_ib)`` with equal shard counts, on ``device``:
    the card unless ``device="cpu"``), each case ``reps`` times.  Returns
    each case's outputs stacked over ranks (CPU tensors, the layout of the
    emulated waves) and each rank's report: per case the host ms of each
    rep and the last rep's exchange ms, calls and bytes; its launch counts;
    its backend, device and mesh.  ``backend`` follows
    ``launch.mesh``'s rule; ranks that share one card need
    ``backend="gloo"``."""
    import torch.multiprocessing as mp

    from . import mesh as meshes

    dev, backend = meshes.mesh_backend(device, backend)
    world = int(states[0][0].root.shape[0])
    if dev.type == "cuda" and backend == "nccl" and world > 1:
        raise ValueError("NCCL runs one rank a card: pass backend='gloo' for ranks that share one")
    for tree, ib in states:
        if tree.root.shape[0] != world or any(t.device != dev for t in (*tree, *ib)):
            raise ValueError(f"every stack needs {world} shards on {dev}")
    with tempfile.TemporaryDirectory(prefix="local_ranks_") as d:
        mp.spawn(
            _rank_main, args=(world, f"{d}/rendezvous", str(dev), backend, states, cases, reps, d),
            nprocs=world, join=True,
        )
        ranks = [torch.load(Path(d) / f"rank{r}.pt", weights_only=False) for r in range(world)]
    if dev.type == "cuda":  # the ranks are gone: release the blocks they held through IPC
        torch.cuda.ipc_collect()
    outs = [
        tuple(torch.cat([rk["outputs"][i][j] for rk in ranks]) for j in range(len(ranks[0]["outputs"][i])))
        for i in range(len(cases))
    ]
    return outs, [{k: rk[k] for k in ("waves", "launches", "backend", "device", "mesh")} for rk in ranks]
