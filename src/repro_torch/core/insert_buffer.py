"""Wave-append into per-leaf insert buffers (Sec 3.1, INSERT/UPDATE/DELETE).

PyTorch port of the JAX package's ``core/insert_buffer.py``.  A wave is
atomic and, within a wave, appends to one leaf land in request order.  A
request whose buffer is full is rejected with RETRY status; the store
retries it after the patch cycle drains the buffer.

The buffers are updated in place (the JAX package donates them).  Every
scatter here writes unique indices, so the result is the same on the CPU
and on CUDA, where duplicate scatter indices have no defined winner.
"""

from __future__ import annotations

import torch

from .lookup import InsertBuffers

STATUS_OK = 0
STATUS_RETRY = 1  # buffer full -> client re-sends after patch cycle
STATUS_NOP = 2  # inactive lane (padding)


def _rank_within_leaf(leaf: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Rank of each active request among the *prior* active requests that
    target the same leaf.  The reference builds a (B, B) matrix; a stable
    sort on the leaf id gives the same ranks in O(B log B)."""
    B = leaf.shape[0]
    key = torch.where(active, leaf.long(), torch.iinfo(torch.int64).max)
    sorted_key, order = torch.sort(key, stable=True)
    group_start = torch.searchsorted(sorted_key, sorted_key, side="left")
    rank = torch.empty(B, dtype=torch.int64, device=leaf.device)
    rank[order] = torch.arange(B, device=leaf.device) - group_start
    return rank


def append_wave(
    ib: InsertBuffers,
    leaf: torch.Tensor,  # (B,) i32 target leaf per request
    khi: torch.Tensor,
    klo: torch.Tensor,
    vhi: torch.Tensor,
    vlo: torch.Tensor,
    op: torch.Tensor,  # (B,) i32 IB_PUT / IB_DEL
    active: torch.Tensor,  # (B,) bool — padding lanes are inactive
):
    """Append a wave of write requests in place.  Returns (buffers, status)."""
    cap = ib.keys.shape[1]
    leaf = leaf.long()
    # a rejected request consumes no slot, but any request behind it on the
    # same leaf has an even larger naive rank, so "offset >= cap -> reject"
    # is self-consistent (as in the reference)
    offset = ib.count[leaf].long() + _rank_within_leaf(leaf, active)
    accept = active & (offset < cap)
    # rejected lanes are masked out instead of scattered out of bounds
    idx = torch.nonzero(accept).squeeze(1)
    lf, off = leaf[idx], offset[idx]
    ib.keys[lf, off] = torch.stack([khi[idx], klo[idx]], dim=-1)
    ib.vals[lf, off] = torch.stack([vhi[idx], vlo[idx]], dim=-1)
    ib.op[lf, off] = op[idx]
    ib.count.index_add_(0, lf, torch.ones_like(lf, dtype=torch.int32))
    status = torch.where(
        active,
        torch.where(accept, STATUS_OK, STATUS_RETRY),
        STATUS_NOP,
    ).to(torch.int32)
    return ib, status


def clear_rows(ib: InsertBuffers, leaves: torch.Tensor) -> InsertBuffers:
    """Reset the buffers of the given leaves in place (the CLEAR part of a
    stitch).  Writing the same zeros twice is harmless, so duplicates need
    no dedupe."""
    leaves = leaves.long()
    ib.keys[leaves] = 0
    ib.vals[leaves] = 0
    ib.op[leaves] = 0
    ib.count[leaves] = 0
    return ib
