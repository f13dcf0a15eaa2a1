"""Run the sharded device waves, and sharded train steps, on ranks spawned
on one host.

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

    reports = spawn_train([(cfg, tcfg, state, batches)], mesh=(2, 2), device="cpu")

``spawn_train`` runs ``make_train_step`` with ``grad_shardings`` on a
``(data, model)`` debug mesh of ``data * model`` ranks: each rank keeps its
blocks of the whole ``state`` (every rank gets it as a spawn argument, as
every rank of ``launch/train.py`` draws it from the seed), takes its rows
of each global batch (``sharding.shard_batch``), steps, and reports its
metrics, its blocks after each step (CPU copies), each block's shape and bytes, the
collectives by kind, step milliseconds and peak device memory.
``spawn_launcher`` runs ``launch/train.py`` itself on spawned ranks.
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



def _train_rank(rank, world, rendezvous, device, backend, mesh_dims, cases, reps, keep_blocks, out_dir):
    import gc

    import torch.distributed as dist

    from . import mesh as meshes

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    meshes.init_process_group(rank, world, f"file://{rendezvous}", device=dev, backend=backend)
    try:
        from ..distributed import sharding as shd

        m = meshes.make_debug_mesh(*mesh_dims, device=dev, backend=backend)
        recs = []
        with shd.collectives(m):  # outside the counter: its times include the host staging
            while cases:
                cfg, tcfg, state, batches, *want = cases.pop(0)
                recs.append(_train_case(m, dev, cfg, tcfg, state, batches, reps, keep_blocks, *want))
                gc.collect()
        torch.save(recs, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
        cases.clear()
        gc.collect()


def _vs(block, want, lay, lr_steps: float) -> Dict:
    """One block against the same block of the whole ``want``: squared
    error and norm sums, the largest difference and, for bf16, the counts
    beyond one ulp and beyond ``lr_steps`` plus one ulp (in pieces of at
    most 2^24 elements: f32 temporaries of a vocabulary-sized leaf)."""
    from ..distributed import sharding as shd

    whole = want[shd.shard_slices(want.shape, lay)]
    sums = torch.zeros(5, dtype=torch.float64, device=block.device)  # num, den, max, beyond ulp, beyond lr + ulp
    rows = max(1, (1 << 24) // max(1, block[0].numel())) if block.dim() else 1
    for i in range(0, max(1, block.shape[0] if block.dim() else 1), rows):
        a = (whole[i : i + rows] if block.dim() else whole).float()
        b = (block[i : i + rows] if block.dim() else block).float()
        d = (b - a).abs()
        ulp = torch.where(a == 0, 0.0, torch.ldexp(torch.ones_like(a), torch.frexp(a).exponent - 8))
        sums += torch.stack([torch.sum(d * d, dtype=torch.float64), torch.sum(a * a, dtype=torch.float64),
                             torch.zeros((), dtype=torch.float64, device=d.device),
                             (d > ulp).sum().double(), (d > lr_steps + ulp).sum().double()])
        sums[2] = torch.maximum(sums[2], d.max().double() if d.numel() else sums[2])
    num, den, mx, beyond, beyond_lr = sums.tolist()  # one sync a leaf
    out = {"num": num, "den": den, "max": mx, "n": block.numel(), "dtype": str(block.dtype).removeprefix("torch.")}
    if block.dtype == torch.bfloat16:
        out.update(beyond_ulp=int(beyond), beyond_lr_ulp=int(beyond_lr))
    return out


def _train_case(m, dev, cfg, tcfg, state, batches, reps, keep_blocks, want=None) -> Dict:
    """One case's steps on this rank (``spawn_train``)."""
    from ..checkpoint.manager import tree_flatten
    from ..distributed import sharding as shd
    from ..kernels import build as kernels
    from .train import build

    kernels.reset_launches()
    step, state_sh = build(cfg, None, m, tcfg)
    st = shd.distribute_tree(state, state_sh)
    state.clear()
    metrics, step_ms, comms, blocks, vs = [], [], [], [], []
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    for i, b in enumerate(batches):
        b = shd.shard_batch({k: (None if v is None else v.to(dev)) for k, v in b.items()}, m, tcfg.microbatches)
        counter = shd.comm_counter(timed=i >= reps)
        _sync(dev)
        t0 = time.perf_counter()
        with counter:
            st, mt = step(st, b)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in mt.items()})
        comms.append(counter.by_kind)
        if keep_blocks:
            blocks.append([x.to_local().detach().to("cpu", copy=True) for x in tree_flatten(st)[0]])
        if want is not None and want[i] is not None:
            with torch.no_grad():
                vs.append([_vs(x.to_local(), w, shd.Layout(x.device_mesh, x.placements), 2 * tcfg.opt.lr * (i + 1))
                           for x, w in zip(tree_flatten(st)[0], tree_flatten(want[i])[0])])
    leaves = tree_flatten(st)[0]
    return {
        "metrics": metrics, "step_ms": step_ms, "collectives": comms, "blocks": blocks, "vs": vs,
        "block_shapes": [tuple(x.to_local().shape) for x in leaves],
        "block_bytes": sum(x.to_local().numel() * x.to_local().element_size() for x in leaves),
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        "held_bytes": held, "coordinate": list(m.get_coordinate()), "launches": dict(kernels.launches),
    }


def spawn_train(cases: List[Tuple], *, mesh: Tuple[int, int] = (2, 1), device=None, backend: Optional[str] = None,
                reps: Optional[int] = None, keep_blocks: bool = True) -> List[List[Dict]]:
    """Each case ``(cfg, tcfg, state, batches[, want])``: ``len(batches)``
    sharded train steps from the whole one-device ``state`` (``init_state``,
    on ``device``) on a ``mesh = (data, model)`` debug mesh of spawned
    ranks, each batch a global batch; the first ``reps`` steps (all by
    default) untimed, the others with each collective timed.  Returns, per
    case, each rank's report (module docstring; its blocks after each step
    where ``keep_blocks``; with ``want``, per step the whole state's leaves
    on ``device`` or ``None``, ``vs``: per step given and leaf the block's
    differences to the same block of ``want``'s, computed on the rank)."""
    import torch.multiprocessing as mp

    from . import mesh as meshes

    dev, backend = meshes.mesh_backend(device, backend)
    world = mesh[0] * mesh[1]
    if dev.type == "cuda" and backend == "nccl" and world > 1:
        raise ValueError("NCCL runs one rank a card: pass backend='gloo' for ranks that share one")
    reps = max(len(c[3]) for c in cases) if reps is None else reps
    with tempfile.TemporaryDirectory(prefix="local_ranks_") as d:
        mp.spawn(_train_rank, args=(world, f"{d}/rendezvous", str(dev), backend, tuple(mesh), list(cases), reps, keep_blocks, d),
                 nprocs=world, join=True)
        ranks = [torch.load(Path(d) / f"rank{r}.pt", weights_only=False) for r in range(world)]
    if dev.type == "cuda":
        torch.cuda.ipc_collect()
    return [[rk[i] for rk in ranks] for i in range(len(cases))]


def _launcher_rank(rank, world, rendezvous, device, backend, argvs, out_dir):
    import torch.distributed as dist

    from . import mesh as meshes
    from . import train

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    meshes.init_process_group(rank, world, f"file://{rendezvous}", device=dev, backend=backend)
    try:
        runs = []
        for argv in argvs:
            losses, state = train.run(train.parse_args(argv))
            runs.append({"losses": losses, "state": state if rank == 0 else None})
        torch.save(runs, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_launcher(argvs: List[List[str]], world: int, *, device=None, backend: Optional[str] = None) -> List[List[Dict]]:
    """``launch/train.py``'s ``run`` on ``world`` spawned ranks, once for each
    argument list in turn; per rank and run its losses and (rank 0) the
    final state, gathered whole."""
    import torch.multiprocessing as mp

    from . import mesh as meshes

    dev, backend = meshes.mesh_backend(device, backend)
    with tempfile.TemporaryDirectory(prefix="local_ranks_") as d:
        mp.spawn(_launcher_rank, args=(world, f"{d}/rendezvous", str(dev), backend, argvs, d), nprocs=world, join=True)
        return [torch.load(Path(d) / f"rank{r}.pt", weights_only=False) for r in range(world)]
