"""Multi-pod dry run of the port: one rank of every (arch x shape x mesh)
cell on a fake process group and the meta device (the counterpart of the
JAX package's ``launch/dryrun.py``).

The reference lowers and compiles each cell's step for the 256-chip pod
and the 512-chip two-pod mesh that are not there.  Torch compiles nothing
ahead of time, but it can *run* rank 0 of such a mesh: a ``fake`` process
group (``torch.testing._internal.distributed.fake_pg``) of 256 or 512
ranks in this one process, whose collectives return at once, a
``DeviceMesh`` of the production shape and names
(``launch.mesh.production_mesh_shape``), and every tensor on the meta
device (shapes, no bytes).  The state, the batch and the caches are
DTensors in the placements of ``distributed/sharding.py`` over meta
blocks, and the cell's own step runs on them: ``make_train_step`` with
``grad_shardings`` (the reference's microbatch and accumulator rules),
the prefill's last-position logits plus its cache, or one ``decode_step``
on caches in ``cache_specs``' placements (gathered to the batch blocks the
port's data-parallel decode reads, written back into their placements).

Each cell's record (``<arch>__<shape>__<mesh>.json`` under ``--out``,
default ``build/dryrun`` of the checkout) keeps the reference's keys where
they mean the same:

  * ``memory.argument_bytes`` — this rank's state, inputs (and caches),
    summed exactly from the blocks' shapes; ``temp_bytes`` and
    ``peak_bytes`` cannot come from meta tensors and are listed under
    ``not_measured``;
  * ``cost.flops`` — ``FlopCounterMode``'s count of rank 0's share of the
    step.  The counter sees every op of every group and microbatch, so
    ``flops_per_device`` is direct: there is no ``_extrapolate`` and no
    ``set_unroll_scan`` (the reference's answer to XLA counting a loop body
    once), as ``models/layers.py`` has no ``UNROLL_ATTN``;
  * ``collectives`` — per kind ``{count, bytes}`` of the functional
    collectives ``CommDebugMode`` sees, bytes of each one's output;
  * ``params_total``, ``params_active``, ``tokens``, ``status``.

The computation is the port's: data parallel with the parameters gathered
at use, and the MoE layer's global dispatch (every rank runs the experts
over the whole microbatch), not the reference's GSPMD tensor parallelism.
``--perf`` takes the reference's flags that change the computation
(``paired_causal``, ``block_kv=N``, ``moe_decode_gather``,
``moe_bf16_combine``); its GSPMD layout names are refused.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

It touches no device memory; run it in a process of its own (a fake group
must not meet a real one in one process).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..checkpoint.manager import tree_flatten
from ..configs import ARCHS, SHAPES, cell_supported
from ..configs.base import ArchConfig, ShapeConfig
from ..distributed import sharding as shd
from ..models import layers, lm
from ..training import optimizer, train_step as ts
from .mesh import production_mesh_shape

RESULTS = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# the reference's --perf names that pin GSPMD layouts: refused, with the reason
GSPMD_FLAGS = ("attn_pin", "cp_decode", "moe_y_shard", "moe_gathered_shard", "moe_decode_local", "attn_rs", "moe_rs")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Optional[Tuple[Tuple[int, ...], torch.dtype]]]:
    """``(shape, dtype)`` of every model input (the reference's
    ``ShapeDtypeStruct`` stand-ins)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.frontend != "none":
            return {"tokens": None, "embeds": ((B, S, cfg.d_model), torch.bfloat16), "labels": ((B, S), torch.int32)}
        return {"tokens": ((B, S), torch.int32), "embeds": None, "labels": ((B, S), torch.int32)}
    tok = ((B, cfg.d_model), torch.bfloat16) if cfg.frontend != "none" else ((B,), torch.int32)
    return {"token": tok, "pos": ((), torch.int32)}


def microbatches_for(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Keep per-microbatch tokens/device ~<= 8k on the big archs."""
    total, _ = cfg.param_counts()
    if total > 1e11:
        return 16
    if total > 2e10:
        return 4
    return 1


def perf_flags(perf) -> Dict:
    """``--perf`` names as ``layers.set_perf_flags`` keywords
    (``block_kv=N`` an int); a GSPMD layout name raises ``ValueError``."""
    gspmd = sorted(set(perf) & set(GSPMD_FLAGS))
    if gspmd:
        raise ValueError(
            f"--perf {gspmd}: GSPMD layout pins of the reference's tensor-parallel program; the port's sharded "
            "step is data parallel and has no such layout (ROADMAP.md)"
        )
    flags = {}
    for f in perf:
        if f.startswith("block_kv="):
            flags["block_kv"] = int(f.split("=")[1])
        else:
            flags[f] = True
    return flags


@contextlib.contextmanager
def fake_mesh(sizes: Tuple[int, ...], names: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``sizes`` / ``names`` over a fake process group
    of ``prod(sizes)`` ranks, this process rank 0; destroyed after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is initialised: the dry run's fake group needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(sizes))
    try:
        yield init_device_mesh("cpu", tuple(sizes), mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def _meta(shape, dtype, lay: shd.Layout):
    """A DTensor of ``shape`` in ``lay`` over a meta block."""
    return shd.dtensor(torch.empty(shd.local_shape(shape, lay), dtype=dtype, device="meta"), lay, shape)


def _meta_tree(tree, layouts):
    return shd.tree_map_with_path(lambda _, x, lay: _meta(tuple(x.shape), x.dtype, lay), tree, layouts)


def _bytes(tree) -> int:
    return sum(x.to_local().numel() * x.to_local().element_size() for x in tree_flatten(tree)[0] if x is not None)


def _batch(cfg, shape, mesh, specs):
    out = {}
    for k, v in input_specs(cfg, shape).items():
        sp = specs.get(k)
        out[k] = None if v is None else _meta(v[0], v[1], shd.Layout(mesh, shd.to_placements(sp, mesh)))
    return out


def _train(cfg, shape, mesh, mb_override):
    total, _ = cfg.param_counts()
    tcfg = ts.TrainConfig(
        opt=optimizer.OptConfig(kind=cfg.optimizer),
        microbatches=mb_override if mb_override is not None else microbatches_for(cfg, shape),
        accum_dtype="bfloat16" if total > 1e11 else "float32",
    )
    from .train import build

    step, state_sh = build(cfg, shape, mesh, tcfg)
    state = _meta_tree(ts.init_state(cfg, tcfg, torch.Generator(), device="meta"), state_sh)
    batch = _batch(cfg, shape, mesh, shd.batch_spec(cfg, shape, mesh))
    args = _bytes(state) + _bytes(batch)
    return (lambda: step(state, batch)), args, {"microbatches": tcfg.microbatches, "accum_dtype": tcfg.accum_dtype}


def _sharded_params(cfg, mesh):
    params_shape = lm.init(cfg, torch.Generator(), device="meta")
    p_sh = shd.spec_layouts(shd.param_specs(cfg, params_shape, mesh), mesh)
    params = _meta_tree(params_shape, p_sh)
    return params, shd.tree_map_with_path(
        lambda _, p: shd.Sharded(p.to_local(), shd.Layout(mesh, p.placements), p.shape), params)


def _prefill(cfg, shape, mesh):
    params, sharded = _sharded_params(cfg, mesh)
    specs = shd.batch_spec(cfg, shape, mesh)
    batch = {k: v for k, v in _batch(cfg, shape, mesh, specs).items() if k != "labels"}
    mode = "prefill" if cfg.causal else "train"

    def run():
        local = {k: (None if v is None else v.to_local()) for k, v in batch.items()}
        with torch.no_grad(), shd.batch_parallel(mesh):
            logits, _, cache = lm.forward(cfg, sharded, tokens=local.get("tokens"), embeds=local.get("embeds"),
                                          mode=mode)
        return logits[:, -1], cache

    return run, _bytes(params) + _bytes(batch), {}


def _decode(cfg, shape, mesh):
    from torch.distributed.tensor import Replicate

    params, sharded = _sharded_params(cfg, mesh)
    spec = lm.cache_spec(cfg, shape.global_batch, shape.seq_len)
    cache_shape = {"slots": [{k: torch.empty(s, dtype=dt, device="meta") for k, (s, dt) in slot.items()}
                             for slot in spec["slots"]]}
    c_sh = shd.spec_layouts(shd.cache_specs(cfg, shape, mesh, cache_shape), mesh)
    cache = _meta_tree(cache_shape, c_sh)
    ba = shd.batch_axes(mesh)
    dp = math.prod(shd.mesh_shape(mesh).size(a) for a in ba)
    tok_sharded = shape.global_batch % dp == 0 and shape.global_batch >= dp
    tshape, tdt = input_specs(cfg, shape)["token"]
    tok_spec = shd.P(ba if tok_sharded else None, *((None,) * (len(tshape) - 1)))
    token = _meta(tshape, tdt, shd.Layout(mesh, shd.to_placements(tok_spec, mesh)))

    def batch_only(x):  # the placements the data-parallel decode reads: batch blocks, the rest whole
        return tuple(p if p.is_shard() and p.dim == 1 and mesh.mesh_dim_names[md] in ba else Replicate()
                     for md, p in enumerate(x.placements))

    def run():
        local = shd.tree_map_with_path(lambda _, c: c.redistribute(mesh, batch_only(c)).to_local(), cache)
        with torch.no_grad(), shd.batch_parallel(mesh) if tok_sharded else contextlib.nullcontext():
            logits, new = lm.decode_step(cfg, sharded, local, token.to_local(), shape.seq_len - 1)
        return logits, shd.tree_map_with_path(
            lambda _, n, c: shd.dtensor(n, shd.Layout(mesh, batch_only(c)), c.shape).redistribute(
                mesh, c.placements), new, cache)

    return run, _bytes(params) + _bytes(cache) + _bytes({"t": token}) + 4, {}


def dry_run(cfg: ArchConfig, shape: ShapeConfig, sizes: Tuple[int, ...], names: Tuple[str, ...],
            perf: tuple = (), mb_override=None) -> dict:
    """Rank 0's step of one cell on a fake ``sizes`` / ``names`` mesh: the
    record's ``memory``, ``cost``, ``collectives`` and timing fields."""
    from torch.utils.flop_counter import FlopCounterMode

    layers.set_perf_flags(**perf_flags(perf))
    try:
        with fake_mesh(sizes, names) as mesh:
            t0 = time.perf_counter()
            if shape.kind == "train":
                run, args, extra = _train(cfg, shape, mesh, mb_override)
            elif shape.kind == "prefill":
                run, args, extra = _prefill(cfg, shape, mesh)
            else:
                run, args, extra = _decode(cfg, shape, mesh)
            build_s = time.perf_counter() - t0
            counter = shd.comm_counter()
            t0 = time.perf_counter()
            with FlopCounterMode(display=False) as flops, counter:
                run()
            run_s = time.perf_counter() - t0
    finally:
        layers.set_perf_flags()
    coll = {k: {"count": int(v["count"]), "bytes": int(v["bytes"])} for k, v in sorted(counter.by_kind.items())}
    return {
        **extra,
        "mesh_shape": list(sizes), "mesh_axes": list(names),
        "memory": {"argument_bytes": int(args), "temp_bytes": None, "peak_bytes": None},
        "not_measured": ["memory.temp_bytes", "memory.peak_bytes"],
        "cost": {"flops": float(flops.get_total_flops())},
        "flops_per_device": float(flops.get_total_flops()),
        "collectives": coll,
        "collective_bytes_per_device": int(sum(v["bytes"] for v in coll.values())),
        "build_s": build_s, "run_s": run_s,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path, perf: tuple = (), mb_override=None) -> dict:
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = f"{arch}__{shape_name}__{mesh_name}"
    ok, reason = cell_supported(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "supported": ok}
    if not ok:
        rec["skip_reason"] = reason
        _write(out_dir, cell, rec)
        return rec
    rec["perf_flags"] = list(perf)
    try:
        sizes, names = production_mesh_shape(multi_pod)
        rec.update(dry_run(cfg, shape, sizes, names, perf=perf, mb_override=mb_override))
        total, active = cfg.param_counts()
        rec["params_total"] = int(total)
        rec["params_active"] = int(active)
        rec["tokens"] = shape.tokens
        rec["status"] = "ok"
        print(
            f"[dryrun] {cell}: OK run={rec['run_s']:.1f}s flops/dev={rec['flops_per_device']:.3e} "
            f"args/dev={rec['memory']['argument_bytes'] / 2**30:.2f}GiB "
            f"coll/dev={rec['collective_bytes_per_device'] / 2**20:.1f}MiB",
            flush=True,
        )
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {cell}: FAIL {rec['error']}", flush=True)
    _write(out_dir, cell, rec)
    return rec


def _write(out_dir: Path, cell: str, rec: dict):
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell}.json").write_text(json.dumps(rec, indent=1, default=str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--perf", default="",
                    help="comma-separated perf flags: paired_causal, block_kv=N, moe_decode_gather, moe_bf16_combine")
    ap.add_argument("--mb", type=int, default=None, help="override microbatches")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    perf = tuple(f for f in args.perf.split(",") if f)
    perf_flags(perf)  # a refused name stops the sweep before its first cell

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    done = failed = 0
    for a in archs:
        for s in shapes:
            for mp in meshes:
                f = out_dir / f"{a}__{s}__{'pod2x16x16' if mp else 'pod16x16'}.json"
                if args.skip_done and f.exists():
                    try:
                        if json.loads(f.read_text()).get("status") == "ok":
                            continue
                    except (OSError, ValueError):
                        pass
                rec = run_cell(a, s, mp, out_dir, perf=perf, mb_override=args.mb)
                done += 1
                failed += rec.get("status") == "error"
    print(f"[dryrun] swept {done} cells -> {out_dir}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
