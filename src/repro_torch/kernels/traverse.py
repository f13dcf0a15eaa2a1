"""Kernel B1: batched learned-index GET (descent + leaf probe + insert-buffer
merge) — the port of the JAX package's ``kernels/traverse.py``
(``_get_kernel`` / ``get_pallas``).

``get`` launches the CUDA kernel (``csrc/traverse.cu``) for CUDA tensors and
runs ``get_plain`` for CPU tensors.  Outputs: ``(vhi, vlo, found)`` with
int32-held u32 values; not-found rows carry 0.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import lookup
from . import build


def get_plain(tree, ib, khi, klo, *, depth: int, eps_inner: int, eps_leaf: int):
    """Plain-torch version of the kernel (same outputs, zeros when absent)."""
    vhi, vlo, found = lookup.get_batch(
        tree, ib, khi, klo, depth=depth, eps_inner=eps_inner, eps_leaf=eps_leaf
    )
    return torch.where(found, vhi, 0), torch.where(found, vlo, 0), found


def get(tree, ib, khi, klo, *, depth: int, eps_inner: int, eps_leaf: int):
    if not khi.is_cuda:
        return get_plain(tree, ib, khi, klo, depth=depth, eps_inner=eps_inner, eps_leaf=eps_leaf)
    return get_cuda(tree, ib, khi, klo, depth=depth, eps_inner=eps_inner, eps_leaf=eps_leaf)


def get_cuda(tree, ib, khi, klo, *, depth: int, eps_inner: int, eps_leaf: int):
    B = khi.shape[0]
    dev = khi.device
    vhi = torch.empty(B, dtype=torch.int32, device=dev)
    vlo = torch.empty(B, dtype=torch.int32, device=dev)
    found = torch.empty(B, dtype=torch.bool, device=dev)
    ins = [
        tree.root,
        tree.node_seg_first,
        tree.node_seg_slope,
        tree.node_seg_count,
        tree.node_seg_slot,
        tree.pivot_keys,
        tree.pivot_child,
        tree.leaf_anchor,
        tree.leaf_slope,
        tree.leaf_count,
        tree.leaf_slot,
        tree.hbm_keys,
        tree.hbm_vals,
        ib.keys,
        ib.vals,
        ib.op,
        ib.count,
        khi,
        klo,
    ]
    fn = build.function("traverse", "dpa_get", n_ptrs=22, n_ints=5)
    err = fn(
        *build.pointers(ins + [vhi, vlo, found], dev),
        B,
        depth,
        eps_inner,
        eps_leaf,
        ib.keys.shape[1],
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    build.check(err, "get")
    build.launches["get"] += 1
    return vhi, vlo, found
