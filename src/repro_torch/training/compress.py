"""Error-feedback int8 gradient compression (the JAX package's
``training/compress.py`` in plain PyTorch):

    q = quantize_int8(g + e)        # per-leaf max-abs scaling
    e' = (g + e) - dequant(q)       # residual stays local
    g_hat = dequant(q)              # what the data-parallel reduce carries

The residual is re-injected at the next step, so the accumulated update
stays unbiased (Karimireddy et al.).  Rounding is half to even and ``q`` is
clipped to +-127, as in the reference.  On one device the quantise /
dequantise pair is a faithful simulation of the wire format.  Under a mesh
(DTensor gradients and errors in the parameters' placements) each leaf's
scale comes from its max-abs all-reduced over the mesh dims that split it,
so every block is quantised on the whole leaf's grid.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..checkpoint.manager import tree_flatten, tree_unflatten


def init_error(params) -> Any:
    leaves, _ = tree_flatten(params)
    return tree_unflatten(params, [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves])


def quantize(g: torch.Tensor, e: torch.Tensor, amax=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale f32 scalar, new residual).  ``amax`` maps the
    block's max-abs to the leaf's (a sharded leaf's all-reduce)."""
    x = g.float() + e
    m = torch.max(torch.abs(x))
    if amax is not None:
        m = amax(m)
    # a true division on every device: divided by a Python number, a CUDA
    # tensor is multiplied by its reciprocal, one rounding off at times
    scale = torch.clamp(m, min=1e-30) / torch.tensor(127.0, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    resid = x - q.float() * scale
    return q, scale, resid


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_tree(grads, errors):
    """Error-feedback int8 compression leaf by leaf.  Returns (dequantised
    grads in each gradient's dtype, ready for the optimizer; new error tree)."""
    from torch.distributed.tensor import DTensor

    from ..distributed import sharding as shd

    flat_g, _ = tree_flatten(grads)
    flat_e, _ = tree_flatten(errors)
    out_g, out_e = [], []
    for g, e in zip(flat_g, flat_e):
        if isinstance(g, DTensor):
            lay = shd.Layout(g.device_mesh, g.placements)
            q, s, r = quantize(g.to_local(), e.to_local(),
                               amax=lambda m: shd.all_reduce(m, lay.mesh, shd.shard_dims(lay), "max"))
            out_g.append(shd.dtensor(dequantize(q, s).to(g.dtype), lay, g.shape))
            out_e.append(shd.dtensor(r, shd.Layout(e.device_mesh, e.placements), e.shape))
            continue
        q, s, r = quantize(g, e)
        out_g.append(dequantize(q, s).to(g.dtype))
        out_e.append(r)
    return tree_unflatten(grads, out_g), tree_unflatten(errors, out_e)
