"""Training launcher of the port (the JAX package's ``launch/train.py``):
(restore | init) -> step loop with checkpointing, the straggler watchdog
and a preemption checkpoint on SIGTERM.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b --reduced --steps 50 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 4 --device cpu

It runs on one device: the CUDA card unless ``--device`` names another
(without CUDA it raises).  There is no mesh and no sharding yet (the
sharding slice brings them), so the loop calls ``make_train_step``'s step
function directly.
Data comes from the step-indexed synthetic stream, so a run restored at
step ``k`` sees the batches an uninterrupted run sees from ``k`` on.
Checkpoints are on-disk compatible with the reference's: a state either
package saved restores in the other.  Weights are drawn from seed 7 with a
``torch.Generator`` on the device (the reference draws its own from
``jax.random.key(7)``; the two differ).
"""

from __future__ import annotations

import argparse
import signal
import time
from typing import Any, Dict, List, Tuple

import torch

from ..checkpoint.manager import CheckpointManager, tree_flatten, tree_unflatten
from ..configs import ARCHS, SHAPES, reduced
from ..configs.base import ArchConfig, ShapeConfig
from ..data.pipeline import DataConfig, SyntheticLM
from ..device import resolve_device
from ..distributed.straggler import Watchdog
from ..training import optimizer, train_step as ts

SEED = 7  # the reference's jax.random.key(7), for the weights and the data


def restore(ckpt: CheckpointManager, step: int, cfg: ArchConfig, tcfg: ts.TrainConfig, device) -> Dict[str, Any]:
    """The state saved at ``step``, each leaf on ``device`` (``None``: the
    card).  The structure, shapes and dtypes come from ``init_state`` on
    the meta device (the reference's ``jax.eval_shape``): nothing is drawn."""
    dev = resolve_device(device)
    like = ts.init_state(cfg, tcfg, torch.Generator(), device="meta")
    leaves, _ = tree_flatten(like)
    return ckpt.restore(step, like, shardings=tree_unflatten(like, [dev] * len(leaves)))


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


def run(args: argparse.Namespace) -> Tuple[List[float], Dict[str, Any]]:
    """The training loop of ``args``; returns the losses of the steps run
    and the final state."""
    dev = resolve_device(args.device)
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
    step_fn = ts.make_train_step(cfg, tcfg)
    data = SyntheticLM(cfg, shape, DataConfig(seed=SEED))
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    dog = Watchdog()

    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        state = restore(ckpt, start, cfg, tcfg, dev)
        print(f"[train] restored step {start}")
    else:
        state = ts.init_state(cfg, tcfg, SEED, device=dev)

    stop = {"now": False}

    def on_sigterm(signum, frame):  # preemption: checkpoint then exit
        stop["now"] = True

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    losses = []
    try:
        for step in range(start, start + args.steps):
            t0 = time.time()
            state, metrics = step_fn(state, to_device(data.global_batch(step), dev))
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            dog.observe(0, dt)
            dog.end_step()
            print(f"[train] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)", flush=True)
            if ckpt and ((step + 1) % args.ckpt_every == 0 or stop["now"]):
                ckpt.save(step + 1, state)
            if stop["now"]:
                print("[train] preemption checkpoint written, exiting", flush=True)
                break
        if ckpt:
            ckpt.wait()
    finally:
        signal.signal(signal.SIGTERM, previous)
    return losses, state


def main(argv=None) -> List[float]:
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
