"""Kernel B5: pack a RANGE wave's results on the device into the layout the
host hands to the client, so that the drain is one copy.

It replaces no TPU kernel: the reference computes the same fields in its
host epilogue (``range_finalize``'s ``join_u64`` / ``np.where`` over the
wave's ``(n, limit)`` rows).  Inputs are the range loop's outputs: key and
value limbs ``rk``, ``rv`` (n, L, 2) int32, the mask ``valid`` (n, L),
``trunc`` (n,), the cursor's ``leaf``, ``khi``, ``klo`` (n,) and the wave's
start-key limbs ``khi``, ``klo`` (n,).  The output is one uint8 buffer
holding, at the offsets of :func:`layout`:

- ``keys``, ``vals`` u64 (n, L): ``hi << 32 | lo`` where valid, 0 elsewhere;
- ``counts`` int64 (n,): the valid slots of each row;
- ``cursor_key`` u64 (n,): the cursor's limbs where the count is > 0, the
  start key's otherwise;
- ``cursor_leaf`` int32 (n,);
- ``truncated`` bool (n,): ``trunc & (counts < L)``.

``pack`` launches the CUDA kernel (``csrc/range_pack.cu``) for CUDA tensors
and runs ``pack_plain`` for CPU tensors; ``unpack`` copies the fields out of
the buffer, once it is on the host, into fresh numpy arrays.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import build

_ALIGN = 16  # every field starts on a 16-byte boundary: the kernel's word


def _up(x: int) -> int:
    return -(-x // _ALIGN) * _ALIGN


class PackLayout(NamedTuple):
    keys: int
    vals: int
    counts: int
    cursor_key: int
    cursor_leaf: int
    truncated: int
    nbytes: int


def layout(n: int, limit: int) -> PackLayout:
    """Byte offsets of the packed fields of an ``(n, limit)`` wave."""
    slots = n * limit * 8
    vals = _up(slots)
    counts = vals + _up(slots)
    cursor_key = counts + _up(8 * n)
    cursor_leaf = cursor_key + _up(8 * n)
    truncated = cursor_leaf + _up(4 * n)
    return PackLayout(0, vals, counts, cursor_key, cursor_leaf, truncated, truncated + _up(n))


def _u64(limbs: torch.Tensor) -> torch.Tensor:
    """int32 limb pairs (..., 2) = (hi, lo) -> int64 holding ``hi << 32 | lo``:
    the little-endian u64 is the lo word, then the hi word."""
    return limbs.flip(-1).contiguous().view(torch.int64)[..., 0]


def pack_plain(rk, rv, valid, trunc, cur_leaf, cur_khi, cur_klo, khi, klo, *, limit: int):
    """Plain-torch version of the kernel: the same buffer, its padding zero."""
    n = rk.shape[0]
    lay = layout(n, limit)
    buf = torch.zeros(lay.nbytes, dtype=torch.uint8, device=rk.device)

    def field(off: int, dtype, shape):
        count = int(np.prod(shape))
        return buf[off : off + count * dtype.itemsize].view(dtype).view(shape)

    counts = valid.sum(dim=1)
    field(lay.keys, torch.int64, (n, limit)).copy_(torch.where(valid, _u64(rk), 0))
    field(lay.vals, torch.int64, (n, limit)).copy_(torch.where(valid, _u64(rv), 0))
    field(lay.counts, torch.int64, (n,)).copy_(counts)
    field(lay.cursor_key, torch.int64, (n,)).copy_(
        torch.where(counts > 0, _u64(torch.stack([cur_khi, cur_klo], -1)), _u64(torch.stack([khi, klo], -1)))
    )
    field(lay.cursor_leaf, torch.int32, (n,)).copy_(cur_leaf)
    field(lay.truncated, torch.bool, (n,)).copy_(trunc & (counts < limit))
    return buf


def pack(rk, rv, valid, trunc, cur_leaf, cur_khi, cur_klo, khi, klo, *, limit: int):
    if not rk.is_cuda:
        return pack_plain(rk, rv, valid, trunc, cur_leaf, cur_khi, cur_klo, khi, klo, limit=limit)
    return pack_cuda(rk, rv, valid, trunc, cur_leaf, cur_khi, cur_klo, khi, klo, limit=limit)


def pack_cuda(rk, rv, valid, trunc, cur_leaf, cur_khi, cur_klo, khi, klo, *, limit: int):
    """Launch kernel B5; raises on operands the kernel does not take.  The
    padding between fields is left unwritten."""
    n = rk.shape[0]
    if limit < 1 or n < 1:
        raise ValueError("the pack needs n >= 1 rows and limit >= 1")
    if rk.shape != (n, limit, 2) or rv.shape != (n, limit, 2) or valid.shape != (n, limit):
        raise ValueError(f"expected rk, rv ({n}, {limit}, 2) and valid ({n}, {limit})")
    rows = (trunc, cur_leaf, cur_khi, cur_klo, khi, klo)
    if any(t.shape != (n,) for t in rows):
        raise ValueError(f"expected trunc, the cursor and the start limbs of shape ({n},)")
    if valid.dtype != torch.bool or trunc.dtype != torch.bool:
        raise TypeError("valid and trunc must be bool")
    if any(t.dtype != torch.int32 for t in (rk, rv, cur_leaf, cur_khi, cur_klo, khi, klo)):
        raise TypeError("the limbs and the cursor leaf must be int32")
    if n >= 2**31 or limit >= 2**31:
        raise ValueError("wave too large for the kernel's int arguments")
    dev = rk.device
    ptrs = build.pointers([rk, rv, valid, *rows], dev)
    if rk.data_ptr() % 16 or rv.data_ptr() % 16:
        raise ValueError("the limb tensors must start on a 16-byte boundary")
    lay = layout(n, limit)
    buf = torch.empty(lay.nbytes, dtype=torch.uint8, device=dev)
    base = buf.data_ptr()
    outs = [ctypes.c_void_p(base + off) for off in lay[:6]]
    fn = build.function("range_pack", "dpa_range_pack", n_ptrs=15, n_ints=2)
    err = fn(*ptrs, *outs, n, limit, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    build.check(err, "range_pack")
    build.launches["range_pack"] += 1
    return buf


def unpack(host: torch.Tensor, n: int, limit: int) -> Tuple[np.ndarray, ...]:
    """Fresh, writable numpy arrays (keys, vals, counts, truncated,
    cursor_leaf, cursor_key) copied out of a packed buffer ``host`` (a uint8
    CPU tensor, at least ``layout(n, limit).nbytes`` long).  The copy is
    torch's, which spreads a large one over the host's threads: at a YCSB-E
    wave (100 MB) numpy's single-threaded copy into fresh pages took ~1.8x
    as long on an H100 machine's 8-core host."""
    lay = layout(n, limit)

    def take(off: int, dtype, shape):
        out = np.empty(shape, dtype=dtype)
        torch.from_numpy(out.reshape(-1).view(np.uint8)).copy_(host[off : off + out.nbytes])
        return out

    return (
        take(lay.keys, np.uint64, (n, limit)),
        take(lay.vals, np.uint64, (n, limit)),
        take(lay.counts, np.int64, (n,)),
        take(lay.truncated, np.bool_, (n,)),
        take(lay.cursor_leaf, np.int32, (n,)),
        take(lay.cursor_key, np.uint64, (n,)),
    )
