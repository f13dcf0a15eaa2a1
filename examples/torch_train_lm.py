"""End-to-end training example of the port: train a ~100M-param
GLM4-family model for a few hundred steps with checkpoint/restart.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --steps 2 --batch 2 --seq 64 --device cpu

The PyTorch twin of ``examples/train_lm.py``: the same config, arguments,
cadence and prints, plus ``--device`` (the CUDA card unless ``cpu`` is
given; without CUDA it raises).  The real data pipeline, optimizer and
checkpoint manager — the code path ``launch/train.py`` runs — at laptop
scale.  Run again with the same ``--ckpt`` it resumes from the newest
checkpoint (one every 100 steps); the default directory is under the
temporary directory.
"""

import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.train import restore, to_device
from repro_torch.training import optimizer, train_step as ts


def hundred_m() -> ArchConfig:
    """A ~100M-param dense config of the glm4 family."""
    return dataclasses.replace(
        ARCHS["glm4-9b"],
        name="glm4-100m",
        n_layers=8,
        d_model=512,
        n_heads=8,
        n_kv_heads=2,
        head_dim=64,
        d_ff=2048,
        vocab_size=32_000,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="the CUDA card unless given; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = hundred_m()
    total, _ = cfg.param_counts()
    print(f"model: {cfg.name}, {total/1e6:.0f}M params on {dev}")
    shape = ShapeConfig("ex", args.seq, args.batch, "train")
    tcfg = ts.TrainConfig(opt=optimizer.OptConfig(lr=6e-4), microbatches=2)
    data = SyntheticLM(cfg, shape, DataConfig(seed=11))
    ckpt = CheckpointManager(args.ckpt, keep=2)

    start = ckpt.latest_step() or 0
    if start:
        state = restore(ckpt, start, cfg, tcfg, dev)
        print(f"resumed from step {start}")
    else:
        state = ts.init_state(cfg, tcfg, 0, device=dev)
    step_fn = ts.make_train_step(cfg, tcfg)  # in place: the state passed in is donated

    t0 = time.time()
    for step in range(start, args.steps):
        state, m = step_fn(state, to_device(data.global_batch(step), dev))
        if step % 20 == 0 or step == args.steps - 1:
            toks = shape.tokens * (step + 1 - start)
            print(
                f"step {step:4d} loss {float(m['loss']):.4f} "
                f"gnorm {float(m['grad_norm']):.3f} "
                f"({toks/(time.time()-t0)/1e3:.1f}k tok/s)"
            )
        if (step + 1) % 100 == 0:
            ckpt.save(step + 1, state)
    ckpt.wait()
    print("done; checkpoints in", args.ckpt)


if __name__ == "__main__":
    main()
