"""Training launcher of the port (the JAX package's ``launch/train.py``):
mesh -> placements -> (restore | init) -> step loop with checkpointing,
the straggler watchdog and a preemption checkpoint on SIGTERM.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b --reduced --steps 50 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 4 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train --reduced --steps 4 --device cpu

It runs on the CUDA card unless ``--device`` names another (without CUDA
it raises).  It uses the default process group when one is initialised
(``torchrun``, or ``run`` called on spawned ranks), else a group of one
rank by ``launch/mesh.py``'s backend rule (NCCL on the card, ``gloo`` on
the CPU), and builds ``make_debug_mesh(data=world, model=1)`` over it, as
the reference builds its mesh over its devices.  ``build`` gives
the step ``grad_shardings`` and the state its placements
(``distributed/sharding.py``): every rank draws the state from the seed
and keeps its blocks, and takes its rows of each step's global batch.
Data comes from the step-indexed synthetic stream, so a run restored at
step ``k`` sees the batches an uninterrupted run sees from ``k`` on.
Checkpoints are on-disk compatible with the reference's: the state is
gathered and rank 0 writes it whole, and a restore places each leaf's
blocks; a state either package saved restores in the other.  Weights are
drawn from seed 7 with a ``torch.Generator`` on the device (the reference
draws its own from ``jax.random.key(7)``; the two differ).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import tempfile
import time
from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist

from ..checkpoint.manager import CheckpointManager, tree_flatten, tree_unflatten
from ..configs import ARCHS, SHAPES, reduced
from ..configs.base import ArchConfig, ShapeConfig
from ..data.pipeline import DataConfig, SyntheticLM
from ..device import resolve_device
from ..distributed import sharding as shd
from ..distributed.straggler import Watchdog
from ..models import lm
from ..training import optimizer, train_step as ts
from . import mesh as meshes

SEED = 7  # the reference's jax.random.key(7), for the weights and the data


def build(cfg: ArchConfig, shape: ShapeConfig, mesh, tcfg: ts.TrainConfig):
    """The step on ``mesh`` and the state's placements (a tree like the
    state of ``sharding.Layout``): the reference's ``build``, parameters by
    ``param_specs``, the optimizer state by ``opt_specs(zero=True)``, the
    error feedback like the parameters; the step pinned to the
    parameters' placements.  Shapes come from the meta device."""
    params_shape = lm.init(cfg, torch.Generator(), device="meta")
    pspecs = shd.param_specs(cfg, params_shape, mesh)
    p_sh = shd.spec_layouts(pspecs, mesh)
    opt_shape = optimizer.init(tcfg.opt, params_shape)
    state_sh = {"params": p_sh, "opt": shd.spec_layouts(shd.opt_specs(cfg, opt_shape, pspecs, mesh, zero=True), mesh)}
    if tcfg.grad_compression:
        state_sh["err"] = p_sh
    return ts.make_train_step(cfg, tcfg, grad_shardings=p_sh), state_sh


def restore(ckpt: CheckpointManager, step: int, cfg: ArchConfig, tcfg: ts.TrainConfig, device,
            shardings=None) -> Dict[str, Any]:
    """The state saved at ``step``, each leaf on ``device`` (``None``: the
    card), or, with ``shardings`` (``build``'s placements), this rank's
    blocks as DTensors.  The structure, shapes and dtypes come from
    ``init_state`` on the meta device (the reference's ``jax.eval_shape``):
    nothing is drawn."""
    like = ts.init_state(cfg, tcfg, torch.Generator(), device="meta")
    if shardings is None:
        dev = resolve_device(device)
        shardings = tree_unflatten(like, [dev] * len(tree_flatten(like)[0]))
    return ckpt.restore(step, like, shardings=shardings)


@contextlib.contextmanager
def process_group(dev: torch.device):
    """The initialised default group; else, under ``torchrun`` (``RANK`` and
    ``WORLD_SIZE`` set), its ranks' group from the environment; else one of
    one rank for the run.  By ``launch/mesh.py``'s backend rule; a group
    made here is destroyed after the run."""
    if dist.is_initialized():
        yield
        return
    env = os.environ
    with tempfile.TemporaryDirectory(prefix="train_pg_") as d:
        if "RANK" in env and "WORLD_SIZE" in env:
            meshes.init_process_group(int(env["RANK"]), int(env["WORLD_SIZE"]), "env://", device=dev)
        else:
            meshes.init_process_group(0, 1, f"file://{os.path.join(d, 'rendezvous')}", device=dev)
        try:
            yield
        finally:
            dist.destroy_process_group()


def to_device(batch, device) -> Dict[str, Any]:
    """A numpy batch of ``SyntheticLM`` as tensors on ``device``."""
    return {k: (None if v is None else torch.from_numpy(v).to(device)) for k, v in batch.items()}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="glm4-9b", choices=sorted(ARCHS))
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=0, help="override global batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq len")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument(
        "--device",
        default=None,
        help="device of the run: the CUDA card unless given (without CUDA it raises); "
        "'cpu' runs on the CPU",
    )
    return ap.parse_args(argv)


def run(args: argparse.Namespace, whole: bool = True) -> Tuple[List[float], Dict[str, Any]]:
    """The training loop of ``args``; returns the losses of the steps run
    and the final state: gathered whole on every rank, or with
    ``whole=False`` as this rank's DTensor blocks."""
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:  # torchrun: a card a rank
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    with process_group(dev):
        losses, state = _run(args, dev)
        return losses, shd.gather_tree(state) if whole else state


def _run(args: argparse.Namespace, dev: torch.device) -> Tuple[List[float], Dict[str, Any]]:
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    shape = SHAPES[args.shape]
    if args.batch or args.seq:
        shape = ShapeConfig("custom", args.seq or shape.seq_len, args.batch or shape.global_batch, "train")
    tcfg = ts.TrainConfig(
        opt=optimizer.OptConfig(kind=cfg.optimizer, lr=args.lr),
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
    )
    world = dist.get_world_size()
    mesh = meshes.make_debug_mesh(world, 1, device=dev, backend=dist.get_backend())
    step_fn, state_sh = build(cfg, shape, mesh, tcfg)
    data = SyntheticLM(cfg, shape, DataConfig(seed=SEED))
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    dog = Watchdog()
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)

    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        state = restore(ckpt, start, cfg, tcfg, dev, shardings=state_sh)
        say(f"[train] restored step {start}")
    else:
        state = ts.init_state(cfg, tcfg, SEED, device=dev, shardings=state_sh)

    stop = {"now": False}

    def on_sigterm(signum, frame):  # preemption: checkpoint then exit
        stop["now"] = True

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    losses = []
    try:
        for step in range(start, start + args.steps):
            t0 = time.time()
            batch = shd.shard_batch(to_device(data.global_batch(step), dev), mesh, args.microbatches)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            dog.observe(0, dt)
            dog.end_step()
            say(f"[train] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)", flush=True)
            if ckpt and ((step + 1) % args.ckpt_every == 0 or stop["now"]):
                ckpt.save(step + 1, state)
            if stop["now"]:
                say("[train] preemption checkpoint written, exiting", flush=True)
                break
        if ckpt:
            ckpt.wait()
            if dist.get_world_size() > 1:  # rank 0's files are there for every rank's next restore
                dist.barrier()
    finally:
        signal.signal(signal.SIGTERM, previous)
    return losses, state


def main(argv=None) -> List[float]:
    return run(parse_args(argv), whole=False)[0]


if __name__ == "__main__":
    main()
