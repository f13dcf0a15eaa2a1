"""B+-tree baseline (Sec 4.2.5) of the port: the JAX package's
``core/btree.py`` in numpy and plain PyTorch.

The paper builds its comparison B+-tree with the same node machinery at
eps = inf: fully packed 2 KB nodes of 128 entries, binary search inside a
node instead of a model prediction.  ``build`` bulk-loads that fully packed
128-ary tree (vectorised: the pools are those of the reference's loop, bit
for bit), ``get_batch`` is the batched point lookup, and the two access
counts feed the Fig-12 comparison.  The reference computes the lookup with
jnp outside any Pallas kernel, so it stays plain torch here and launches no
kernel.

Access counting (what Fig 12 is about):
  * learned inner node: 1 meta line + 1 model line + ~1.5 pivot lines + 1
    child line = 4.5 lines on average (paper Sec 4.2.6);
  * B+-tree inner node: binary search over 128 keys spread across 16 cache
    lines touches ~log2(16) = 4 distinct key lines + 1 child line + 1 meta
    line = 6 lines;
  * learned leaf: the eps_leaf window is contiguous -> ONE host DMA + one
    value DMA;
  * B+-tree leaf: binary search over the key array in host memory -> ~4
    dependent DMA line accesses + one value DMA.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .keys import KEY_MAX, limb_eq, limb_le, limbs_to_tensor, split_u64, u32
from .lookup import take

FANOUT = 128  # 2 KB nodes: 128 x (8 B key + 8 B pointer)


class BTree(NamedTuple):
    depth: int  # levels including the leaf level
    node_keys: torch.Tensor  # (N, 128, 2) u32 limbs held in int32, the inner levels root first
    node_child: torch.Tensor  # (N, 128) int32, -1 past the last child
    level_base: Tuple[int, ...]  # base node id of each inner level
    leaf_keys: torch.Tensor  # (L, 128, 2) u32 limbs, padded KEY_MAX
    leaf_vals: torch.Tensor  # (L, 128, 2) u32 limbs, padded 0
    n_leaves: int
    # (N,) int64: per inner node, the pool id its child ids count from (the
    # next inner level's base, 0 where the children are leaves)
    child_base: torch.Tensor


def _pack(a: np.ndarray, fill, dtype) -> np.ndarray:
    """``a`` in rows of FANOUT, the last row padded with ``fill``."""
    m = math.ceil(a.size / FANOUT)
    out = np.full(m * FANOUT, fill, dtype=dtype)
    out[: a.size] = a
    return out.reshape(m, FANOUT)


def build(keys: np.ndarray, vals: np.ndarray, device=None) -> BTree:
    """Bulk-loads sorted u64 ``keys`` and their ``vals`` into the fully
    packed tree, on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    keys = np.asarray(keys, dtype=np.uint64)
    vals = np.asarray(vals, dtype=np.uint64)
    n_leaves = math.ceil(keys.size / FANOUT)
    lk = _pack(keys, KEY_MAX, np.uint64)
    lv = _pack(vals, 0, np.uint64)

    levels = []  # (keys (m, 128) u64, child (m, 128) i32), leaf level upwards
    child_firsts = lk[:, 0].copy()
    n_children = n_leaves
    while n_children > 1:
        nk = _pack(child_firsts, KEY_MAX, np.uint64)
        nc = _pack(np.arange(n_children, dtype=np.int32), -1, np.int32)
        levels.append((nk, nc))
        child_firsts = nk[:, 0].copy()
        n_children = nk.shape[0]
    if not levels:  # a single leaf: a trivial root
        nk = np.full((1, FANOUT), KEY_MAX, dtype=np.uint64)
        nc = np.full((1, FANOUT), -1, dtype=np.int32)
        nk[0, 0], nc[0, 0] = lk[0, 0], 0
        levels.append((nk, nc))

    levels = levels[::-1]  # root first, so ids are stable
    sizes = [nk.shape[0] for nk, _ in levels]
    bases = tuple(int(b) for b in np.cumsum([0] + sizes[:-1]))
    child_base = np.repeat(np.array(bases[1:] + (0,), dtype=np.int64), sizes)
    return BTree(
        depth=len(levels) + 1,
        node_keys=limbs_to_tensor(split_u64(np.concatenate([nk for nk, _ in levels])), dev),
        node_child=torch.from_numpy(np.concatenate([nc for _, nc in levels])).to(dev),
        level_base=bases,
        leaf_keys=limbs_to_tensor(split_u64(lk), dev),
        leaf_vals=limbs_to_tensor(split_u64(lv), dev),
        n_leaves=n_leaves,
        child_base=torch.from_numpy(child_base).to(dev),
    )


def _node_rank(rows_k: torch.Tensor, kh: torch.Tensor, kl: torch.Tensor) -> torch.Tensor:
    """Last index with key <= k by a full compare (the batched analogue of
    binary search: the same index)."""
    le = limb_le(u32(rows_k[:, :, 0]), u32(rows_k[:, :, 1]), kh[:, None], kl[:, None])
    return le.sum(dim=1) - 1


def get_batch(bt: BTree, khi: torch.Tensor, klo: torch.Tensor):
    """Batched point lookup of the int32-held u32 limbs ``khi``, ``klo``.
    Returns (vhi, vlo, found): the value limbs (int32-held u32) and a bool
    per request.  Every gather follows the reference's rule (a negative id
    counts from the end, then ids are clamped), so a request for KEY_MAX,
    which descends through a padding slot, answers as the reference does.

    ``node_child`` holds ids within the next level, so the descent adds the
    pool id that level starts at.  The reference's ``get_batch`` does not:
    from depth 3 on it reads the root's child ids as pool ids and misses
    present keys (its own test builds a depth-2 tree).  The port computes
    the reference's descent over pool ids, and at depth 2 (every child a
    leaf) the reference's own."""
    kh, kl = u32(khi), u32(klo)
    node = torch.zeros(khi.shape[0], dtype=torch.int64, device=khi.device)  # the root is id 0
    for _ in range(bt.depth - 1):
        rank = torch.clamp(_node_rank(take(bt.node_keys, node), kh, kl), min=0)
        child = torch.gather(take(bt.node_child, node), 1, rank[:, None])[:, 0].long()
        # the base of the node read, not of the level: KEY_MAX's padding
        # child -1 lands on the last node of the level above
        node = child + take(bt.child_base, node)
    rows_k = take(bt.leaf_keys, node)
    rank = _node_rank(rows_k, kh, kl)
    safe = torch.clamp(rank, min=0)[:, None, None].expand(-1, 1, 2)
    kk = torch.gather(rows_k, 1, safe)[:, 0]
    found = (rank >= 0) & limb_eq(u32(kk[:, 0]), u32(kk[:, 1]), kh, kl)
    vv = torch.gather(take(bt.leaf_vals, node), 1, safe)[:, 0]
    return vv[:, 0], vv[:, 1], found


# ---------------------------------------------------------------------------
# access-count model (consumed by the Fig-12 comparison and perfmodel)
# ---------------------------------------------------------------------------


def inner_lines_touched() -> float:
    """Distinct cache lines touched by binary search in a full 2 KB node."""
    key_lines = math.log2(FANOUT * 8 / 64)  # 16 lines -> ~4 probes
    return 1 + key_lines + 1  # meta + key probes + child line


def leaf_dmas_touched() -> float:
    """Dependent DMA line accesses for binary search in a host-memory leaf."""
    return math.log2(FANOUT * 8 / 64) + 1  # key probes + value fetch
