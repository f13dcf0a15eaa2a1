"""Paged KV cache whose page table IS a DPA-Store learned index — the port
of the JAX package's ``serving/paged_cache.py``.

The page table is an *ordered* map

    key   = (seq_id << BLOCK_BITS) | block_idx      (u64, ordered)
    value = pool slot id

held in the port's ``DPAStore``: appending into an existing block is a point
GET, starting a block is a PUT, and collecting a sequence's blocks in order
is a RANGE.  The block pools are torch tensors on the store's device; the
listed blocks of both pools are copied out by one launch of kernel B4
(``kernels/paged_gather.py``).

Unlike the reference, which rebuilds its immutable pool on every write
(``.at[slot, offset].set``), the port writes the pools in place; the gather
returns a fresh buffer, so a gathered sequence never changes under a later
append.  ``gather`` takes no ``impl`` argument: the pools' device picks
kernel B4 (CUDA) or its plain version (CPU).  One ``PagedCache`` manages
one (kv_heads, head_dim) pool.  ``from_state`` builds a cache over given
pools with a bulk-loaded page table, and ``from_numpy`` / ``to_numpy`` carry
a whole cache between the JAX package and the port.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core import DPAStore, TreeConfig
from ..core.hotcache import CacheConfig
from ..core.store import resolve_device
from ..kernels import ops

BLOCK_BITS = 20  # up to 2^20 blocks per sequence
_SENTINEL_SEQ = (1 << 43) - 1  # bulk-load seed key (real seqs stay below)


def page_key(seq_id: int, block_idx: int) -> int:
    return (int(seq_id) << BLOCK_BITS) | int(block_idx)


def _pool_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:  # bf16 bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _pool_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


class PagedCache:
    def __init__(
        self,
        n_blocks: int,
        block_size: int,
        kv_heads: int,
        head_dim: int,
        dtype=torch.bfloat16,
        tree_cfg: TreeConfig = TreeConfig(ib_cap=32, growth=8.0),
        device=None,
    ):
        device = resolve_device(device)
        shape = (n_blocks, block_size, kv_heads, head_dim)
        # the page table starts with one sentinel mapping: the store needs a
        # non-empty tree
        seed = (np.array([page_key(_SENTINEL_SEQ, 0)], dtype=np.uint64), np.array([0], dtype=np.uint64))
        self._setup(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            list(range(n_blocks - 1, -1, -1)),
            {},
            seed,
            tree_cfg,
        )

    def _setup(self, pool_k, pool_v, free, seq_len, items, tree_cfg) -> None:
        self.device = pool_k.device
        self.n_blocks, self.block_size = pool_k.shape[:2]
        self.pool_k, self.pool_v = pool_k, pool_v
        self.free: List[int] = free  # pop order: the last is taken next
        self.seq_len: Dict[int, int] = seq_len  # live length per sequence
        self.table = DPAStore(
            *items,
            tree_cfg,
            cache_cfg=CacheConfig(n_threads=16, admit_shift=0),
            device=self.device,
        )

    @classmethod
    def from_state(
        cls,
        pool_k: torch.Tensor,
        pool_v: torch.Tensor,
        free: List[int],
        seq_len: Dict[int, int],
        items: Tuple[np.ndarray, np.ndarray],
        tree_cfg: TreeConfig = TreeConfig(ib_cap=32, growth=8.0),
    ) -> "PagedCache":
        """A cache over the given (N, bs, Hkv, hd) pools, which it then
        writes in place, with its free slot list in pop order, ``{seq_id:
        length}``, and its page table bulk-loaded from ``items``, the
        ``(keys, vals)`` u64 arrays of a table's ``items()``."""
        pc = cls.__new__(cls)
        keys, vals = items
        pc._setup(
            pool_k,
            pool_v,
            [int(s) for s in free],
            {int(s): int(n) for s, n in dict(seq_len).items()},
            (np.asarray(keys, np.uint64), np.asarray(vals, np.uint64)),
            tree_cfg,
        )
        return pc

    @classmethod
    def from_numpy(cls, d: Dict[str, object], device) -> "PagedCache":
        """The carry of a JAX ``PagedCache``: ``{"pool_k", "pool_v", "free",
        "seq_len", "items"}`` as numpy, bf16 pools as ``ml_dtypes.bfloat16``
        or raw ``uint16`` bits (carried bit for bit)."""
        device = resolve_device(device)
        pools = (_pool_from_numpy(d[f], device) for f in ("pool_k", "pool_v"))
        return cls.from_state(*pools, d["free"], d["seq_len"], d["items"])

    def to_numpy(self) -> Dict[str, object]:
        """The inverse of ``from_numpy``; bf16 pools as ``uint16`` bits."""
        return {
            "pool_k": _pool_to_numpy(self.pool_k),
            "pool_v": _pool_to_numpy(self.pool_v),
            "free": np.asarray(self.free, dtype=np.int64),
            "seq_len": dict(self.seq_len),
            "items": self.table.items(),
        }

    # ------------------------------------------------------------ write path
    def append(self, seq_id: int, k, v) -> None:
        """Append one token's (kv_heads, head_dim) K/V for a sequence, cast
        to the pool's dtype (round to nearest even, as the reference)."""
        pos = self.seq_len.get(seq_id, 0)
        block_idx, offset = divmod(pos, self.block_size)
        key = np.array([page_key(seq_id, block_idx)], dtype=np.uint64)
        if offset == 0:
            slot = self.free.pop()
            self.table.put(key, np.array([slot], dtype=np.uint64))
        else:
            vals, found = self.table.get(key)
            if not found[0]:
                raise RuntimeError(f"page table lost block {seq_id}/{block_idx}")
            slot = int(vals[0])
        for pool, x in ((self.pool_k, k), (self.pool_v, v)):
            pool[slot, offset] = torch.as_tensor(x, device=self.device).to(pool.dtype)
        self.seq_len[seq_id] = pos + 1

    def release(self, seq_id: int) -> int:
        """Finish a sequence: delete its pages, reclaim pool slots."""
        n = self.seq_len.pop(seq_id, 0)
        n_blocks = (n + self.block_size - 1) // self.block_size
        keys = np.array([page_key(seq_id, b) for b in range(n_blocks)], dtype=np.uint64)
        if n_blocks:
            vals, found = self.table.get(keys)
            self.free.extend(int(v) for v, f in zip(vals, found) if f)
            self.table.delete(keys)
        return n_blocks

    # ------------------------------------------------------------- read path
    def lookup_slots(self, seq_id: int) -> np.ndarray:
        """RANGE over the learned index: the sequence's pool slots in block
        order."""
        n = self.seq_len.get(seq_id, 0)
        n_blocks = (n + self.block_size - 1) // self.block_size
        if n_blocks == 0:
            return np.zeros((0,), dtype=np.int32)
        start = np.array([page_key(seq_id, 0)], dtype=np.uint64)
        keys, vals, cnt = self.table.range(
            start, limit=n_blocks, max_leaves=max(4, n_blocks // 16 + 2)
        )
        got = int(cnt[0])
        # ordered keys make the guard against another sequence's pages a
        # prefix check
        expect = np.array([page_key(seq_id, b) for b in range(n_blocks)], dtype=np.uint64)
        if got != n_blocks or not np.array_equal(keys[0][:got], expect):
            raise RuntimeError(f"page table RANGE of sequence {seq_id}: {got} of {n_blocks} blocks")
        return vals[0][:got].astype(np.int32)

    def gather(self, seq_id: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Materialise a sequence's (S_padded, H, hd) K/V via the page table.
        Returns (k, v, valid_len)."""
        slots = torch.from_numpy(self.lookup_slots(seq_id)).to(self.device)
        n = self.seq_len.get(seq_id, 0)
        k, v = ops.paged_gather_kv(self.pool_k, self.pool_v, slots)
        S = slots.shape[0] * self.block_size
        return k.reshape(S, *k.shape[2:]), v.reshape(S, *v.shape[2:]), n
