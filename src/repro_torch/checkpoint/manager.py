"""Fault-tolerant checkpointing: atomic, mesh-independent, async — the
PyTorch port of the JAX package's ``checkpoint/manager.py``.

Layout (one directory per step), byte-compatible with the reference's, so a
checkpoint written by either package restores in the other:

    ckpt_dir/
      step_000000100.tmp/         # written first
        META.json                 # step, leaf count, tree structure, shapes, dtypes
        arr_000000.npy ...        # one file per leaf (host copy)
      step_000000100/             # atomic rename == commit

The reference flattens its state with ``jax.tree.flatten``; here
:func:`tree_flatten` walks the same structures in the same order: a dict in
sorted-key order, lists, tuples and NamedTuples in order, ``None`` as an
empty node, anything else (a tensor, an array, a scalar) as a leaf.  The
``treedef`` string in META is descriptive only; a reader takes the leaves in
flatten order.

Properties (as the reference's):

  * **atomic commit** — a crash mid-write leaves only ``*.tmp``, which
    ``latest_step`` ignores and ``clean_tmp`` removes;
  * **mesh independence** — leaves are saved as whole host arrays and
    restored onto whatever device the caller's ``like`` tensors (or
    ``shardings``) name;
  * **async save** — the device-to-host copy of every leaf is taken
    synchronously, before the writer thread starts (a consistent cut even
    when the caller mutates its tensors in place right after), and the file
    writes run on the thread; ``wait()`` joins before the next save.

dtypes numpy cannot hold (bf16, the fp8 types) are stored as a same-width
unsigned-integer view, with the true dtype's name in META.

A sharded state (DTensor leaves, ``distributed/sharding.py``) is saved
whole: every rank all-gathers each leaf and rank 0 writes, so the files are
the one-device layout.  ``restore`` places a leaf whose ``shardings`` entry
is a ``sharding.Layout`` as a DTensor: each rank keeps its block.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# torch dtypes without a numpy equivalent -> the name META carries (the
# reference's ml_dtypes names)
_EXOTIC = {
    torch.bfloat16: "bfloat16",
    torch.float8_e4m3fn: "float8_e4m3fn",
    torch.float8_e5m2: "float8_e5m2",
}
_EXOTIC_BY_NAME = {v: k for k, v in _EXOTIC.items()}
_SIGNED_VIEW = {1: torch.int8, 2: torch.int16}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


# The walks are module-level functions, not closures that call themselves: a
# self-referencing closure is a reference cycle that would keep every leaf
# it saw (a whole train state) alive until the cyclic collector runs.


def _walk(x, leaves: List[Any]) -> str:
    if x is None:
        return "None"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{k!r}: {_walk(x[k], leaves)}" for k in sorted(x)) + "}"
    if _is_namedtuple(x):
        return f"CustomNode(namedtuple[{type(x).__name__}], [" + ", ".join(_walk(v, leaves) for v in x) + "])"
    if isinstance(x, tuple):
        return "(" + ", ".join(_walk(v, leaves) for v in x) + ("," if len(x) == 1 else "") + ")"
    if isinstance(x, list):
        return "[" + ", ".join(_walk(v, leaves) for v in x) + "]"
    leaves.append(x)
    return "*"


def tree_flatten(state: Any) -> Tuple[List[Any], str]:
    """Leaves of ``state`` in the reference's flatten order, and a
    description of its structure (META's ``treedef``)."""
    leaves: List[Any] = []
    return leaves, f"PyTreeDef({_walk(state, leaves)})"


def _build(x, it):
    if x is None:
        return None
    if isinstance(x, dict):
        out = {k: _build(x[k], it) for k in sorted(x)}
        return {k: out[k] for k in x}  # the caller's key order
    if _is_namedtuple(x):
        return type(x)(*(_build(v, it) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_build(v, it) for v in x)
    return next(it)


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """Rebuild the structure of ``like`` with ``leaves`` in flatten order."""
    it = iter(leaves)
    out = _build(like, it)
    assert next(it, None) is None, "more leaves than the structure holds"
    return out


def _host_copy(x) -> Tuple[np.ndarray, str]:
    """A host numpy copy of one leaf and its true dtype's name; a dtype
    numpy cannot hold is copied as its same-width unsigned view."""
    if isinstance(x, torch.Tensor):
        if hasattr(x, "full_tensor"):  # a DTensor: gathered whole
            x = x.full_tensor()
        t = x.detach().to("cpu", copy=True)
        if t.dtype in _EXOTIC:
            size = t.element_size()
            return t.view(_SIGNED_VIEW[size]).numpy().view(np.dtype(f"u{size}")), _EXOTIC[t.dtype]
        a = t.numpy()
        return a, str(a.dtype)
    a = np.array(x, copy=True)
    name = str(a.dtype)
    if a.dtype.kind not in "biufc":  # e.g. an ml_dtypes bf16 array
        a = a.view(np.dtype(f"u{a.dtype.itemsize}"))
    return a, name


def _load_leaf(path: Path, dtype: str):
    """One stored leaf with its true dtype: a numpy array, or a CPU tensor
    for a dtype numpy cannot hold."""
    a = np.load(path)
    if dtype in _EXOTIC_BY_NAME:
        tdt = _EXOTIC_BY_NAME[dtype]
        return torch.from_numpy(a.view(np.dtype(f"i{a.dtype.itemsize}"))).view(tdt)
    true_dt = np.dtype(dtype)
    if a.dtype != true_dt:
        a = a.view(true_dt)
    return a


def _sharded_follower(leaves) -> bool:
    """A rank other than 0 saving a sharded state (it gathered, rank 0
    writes)."""
    import torch.distributed as dist

    return (any(hasattr(x, "full_tensor") for x in leaves) and dist.is_initialized()
            and dist.get_rank() != 0)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Snapshot ``state`` (any tree of tensors, numpy arrays and
        scalars) at ``step``."""
        self.wait()
        leaves, treedef_str = tree_flatten(state)
        copies = [_host_copy(x) for x in leaves]  # consistent cut, before the thread
        if _sharded_follower(leaves):
            return  # rank 0 writes the gathered state
        host = [a for a, _ in copies]
        dtypes = [name for _, name in copies]

        def write():
            tmp = self.dir / f"step_{step:09d}.tmp"
            final = self.dir / f"step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            meta = {
                "step": step,
                "n_leaves": len(host),
                "treedef": treedef_str,
                "shapes": [list(a.shape) for a in host],
                "dtypes": dtypes,
            }
            for i, a in enumerate(host):
                np.save(tmp / f"arr_{i:06d}.npy", a)
            (tmp / "META.json").write_text(json.dumps(meta))
            os.replace(tmp, final)  # atomic commit
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
                if (p / "META.json").exists():
                    out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """Restore into the structure of ``like`` (a tree of tensors or
        arrays).  A tensor leaf comes back as a tensor of ``like``'s dtype
        on ``like``'s device, or on the device ``shardings`` (same
        structure, or None) names for it — the elastic-restart entry point;
        an array leaf comes back as a numpy array of its dtype."""
        d = self.dir / f"step_{step:09d}"
        meta = json.loads((d / "META.json").read_text())
        from ..distributed import sharding as shd

        leaves_like, _ = tree_flatten(like)
        assert meta["n_leaves"] == len(leaves_like), (
            f"checkpoint has {meta['n_leaves']} leaves, target {len(leaves_like)}"
        )
        devices = tree_flatten(shardings)[0] if shardings is not None else [None] * len(leaves_like)
        out = []
        for i, (lk, dev) in enumerate(zip(leaves_like, devices)):
            a = _load_leaf(d / f"arr_{i:06d}.npy", meta["dtypes"][i])
            assert list(a.shape) == list(lk.shape), (i, a.shape, lk.shape)
            if isinstance(lk, torch.Tensor):
                t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, order="C"))
                if isinstance(dev, shd.Layout):  # this rank's block, as a DTensor
                    block = t[shd.shard_slices(t.shape, dev)]
                    block = block.to(device=torch.device(dev.mesh.device_type), dtype=lk.dtype).contiguous()
                    out.append(shd.dtensor(block, dev, t.shape))
                    continue
                out.append(t.to(device=lk.device if dev is None else dev, dtype=lk.dtype))
            else:
                out.append(np.asarray(a).astype(np.asarray(lk).dtype))
        return tree_unflatten(like, out)

    def restore_arrays(self, step: int) -> Tuple[Dict[str, Any], list]:
        """Shape-free restore: ``(meta, leaves)`` — the raw host leaves in
        flatten order (numpy arrays; a CPU tensor for a dtype numpy cannot
        hold) — without a ``like`` tree.  A shard-count-independent snapshot
        needs this: the reader learns the shapes from the checkpoint."""
        d = self.dir / f"step_{step:09d}"
        meta = json.loads((d / "META.json").read_text())
        leaves = [_load_leaf(d / f"arr_{i:06d}.npy", meta["dtypes"][i]) for i in range(meta["n_leaves"])]
        return meta, leaves

    def clean_tmp(self) -> int:
        n = 0
        for p in self.dir.iterdir():
            if p.name.endswith(".tmp"):
                shutil.rmtree(p, ignore_errors=True)
                n += 1
        return n
