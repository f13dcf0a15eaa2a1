"""Optimizers of the port: AdamW and Adafactor over the parameter tree (the
JAX package's ``training/optimizer.py`` in plain PyTorch).

State trees mirror the parameter tree: ``{"step", "m", "v"}`` for AdamW,
``{"step", "vr", "vc"}`` for Adafactor, the moments f32 and ``step`` an
int32 scalar tensor, so a checkpoint of either package restores in the
other.  Adafactor (factored second moment, no first moment) is the 398-405B
configs' optimizer: f32 Adam moments for those do not fit.

``update`` is an explicit loop over the leaves: one leaf's gradient is cast
to f32 and clipped, and its moments and parameter are updated, before the
next leaf is touched.  That is the reference's ``_sequenced_map``: the f32
temporaries of one leaf at a time, never a whole-tree f32 copy.  The
arithmetic is the reference's, op for op: the update is computed in f32 and
cast to the parameter's dtype once (``torch.optim.AdamW`` decays the bf16
parameter before its step and rounds differently).

The step is done in place: the params and state passed in are donated (the
reference jits its step with ``donate_argnums``), their tensors take the new
values and are returned.

Under a mesh (params, grads and state DTensors in the placements of
``distributed.sharding``) the update runs on the blocks.  AdamW is
elementwise: it runs in each moment's placement (ZeRO: the gradient and
parameter blocks sliced to it, the new parameter block all-gathered back
where the parameter is not split like its moments).  Adafactor runs in the
parameter's placement; its factored row and column means, the mean of
``vr`` and the update's RMS are all-reduced where a reduced dimension is
split.  The global gradient norm is the all-reduced f32 sum of squares of
each leaf (each block counted once), summed over the leaves in order.  On
a mesh of one rank every number is the unsharded update's, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..checkpoint.manager import tree_flatten, tree_unflatten
from ..models.layers import mean


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    factored_min: int = 128  # factor second moment only for >=2D leaves this big


def _map(fn, tree):
    leaves, _ = tree_flatten(tree)
    return tree_unflatten(tree, [fn(p) for p in leaves])


def _factored(cfg: OptConfig, p: torch.Tensor) -> bool:
    return p.dim() >= 2 and min(p.shape[-2:]) >= cfg.factored_min


def init(cfg: OptConfig, params) -> Dict[str, Any]:
    """Zero moments shaped like ``params``, on their device."""
    device = tree_flatten(params)[0][0].device
    step = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.kind == "adamw":
        return {
            "step": step,
            "m": _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
            "v": _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        }
    if cfg.kind == "adafactor":

        def vrow(p):
            shape = p.shape[:-1] if _factored(cfg, p) else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vcol(p):
            shape = (*p.shape[:-2], p.shape[-1]) if _factored(cfg, p) else (1,)  # (1,): unused sentinel
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return {"step": step, "vr": _map(vrow, params), "vc": _map(vcol, params)}
    raise ValueError(cfg.kind)


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over the leaves (in flatten order) of each leaf's f32
    sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_flatten(grads)[0]))


def _adamw_leaf(cfg: OptConfig, p, g, m, v, scale, bc1, bc2) -> None:
    g = g.float() * scale
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    del g
    delta = m / bc1
    delta.div_(torch.sqrt(v / bc2).add_(cfg.eps))
    pf = p.float()
    delta.add_(cfg.weight_decay * pf)
    p.copy_(pf - cfg.lr * delta)


def _adafactor_leaf(cfg: OptConfig, p, g, vr, vc, scale, decay, means=None, factored=None) -> None:
    # ``means(x, what, dim, keepdim)``: a mean over a sharded block (what:
    # "p" a tensor in the parameter's placement, "vr" one in vr's)
    means = means or (lambda x, what, dim=None, keepdim=False: mean(x, dim=dim, keepdim=keepdim))
    g = g.float() * scale
    g2 = g * g + 1e-30
    if _factored(cfg, p) if factored is None else factored:
        vr.mul_(decay).add_((1 - decay) * means(g2, "p", dim=-1))
        vc.mul_(decay).add_((1 - decay) * means(g2, "p", dim=-2))
        r = vr / torch.clamp(means(vr, "vr", dim=-1, keepdim=True), min=1e-30)
        vhat = r[..., None] * vc[..., None, :]
    else:
        vr.mul_(decay).add_((1 - decay) * g2)
        vhat = vr
    del g2
    upd = g / torch.sqrt(vhat + cfg.eps)
    del g, vhat
    # update clipping (RMS <= 1): adafactor's stabiliser
    rms = torch.sqrt(means(torch.square(upd), "p") + 1e-30)
    upd.div_(torch.clamp(rms, min=1.0))
    pf = p.float()
    p.copy_(pf - cfg.lr * upd - cfg.lr * cfg.weight_decay * pf)


def clip_scale(cfg: OptConfig, gnorm: torch.Tensor) -> torch.Tensor:
    """``min(1, grad_clip / max(gnorm, 1e-9))`` with the quotient rounded
    once, as the reference rounds it: a Python number divided by a tensor
    is a reciprocal times the number in PyTorch, two roundings."""
    clip = torch.full_like(gnorm, cfg.grad_clip)
    return torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)


@torch.no_grad()
def update(cfg: OptConfig, params, grads, state) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One optimizer step, in place (see the module docstring).  Returns
    (params, state, {"grad_norm"})."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree_flatten(params)[0][0], DTensor):
        return _update_sharded(cfg, params, grads, state)
    gnorm = _global_norm(grads)
    scale = clip_scale(cfg, gnorm)
    step = state["step"] + 1
    stepf = step.float()
    p_l, g_l = tree_flatten(params)[0], tree_flatten(grads)[0]

    if cfg.kind == "adamw":
        bc1 = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device) ** stepf
        bc2 = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device) ** stepf
        for p, g, m, v in zip(p_l, g_l, tree_flatten(state["m"])[0], tree_flatten(state["v"])[0]):
            _adamw_leaf(cfg, p, g, m, v, scale, bc1, bc2)
    elif cfg.kind == "adafactor":
        decay = 1.0 - stepf**-0.8
        for p, g, vr, vc in zip(p_l, g_l, tree_flatten(state["vr"])[0], tree_flatten(state["vc"])[0]):
            _adafactor_leaf(cfg, p, g, vr, vc, scale, decay)
    else:
        raise ValueError(cfg.kind)
    state["step"] = step
    return params, state, {"grad_norm": gnorm}


# ------------------------------------------------------------- on a mesh


def _work(x, placements) -> torch.Tensor:
    """The block of the DTensor ``x`` in ``placements`` (its own block, the
    same storage, where they are its own)."""
    if tuple(x.placements) == tuple(placements):
        return x.to_local()
    return x.redistribute(x.device_mesh, placements).to_local()


def _put_back(x, block: torch.Tensor, placements) -> None:
    """Write ``block``, ``x``'s values in ``placements``, into ``x``."""
    if tuple(x.placements) == tuple(placements):
        return
    from ..distributed import sharding as shd

    full = shd.dtensor(block, shd.Layout(x.device_mesh, placements), x.shape)
    x.to_local().copy_(full.redistribute(x.device_mesh, x.placements).to_local())


def _sharded_norm(grads) -> torch.Tensor:
    """``_global_norm`` of DTensor gradients: each leaf's f32 sum of squares
    all-reduced over the mesh (its replicas but one add zero), then summed
    over the leaves in order."""
    from ..distributed import sharding as shd

    leaves = tree_flatten(grads)[0]
    sums = []
    for g in leaves:
        s = torch.sum(torch.square(g.to_local().float()))
        sums.append(s if shd.owns(shd.Layout(g.device_mesh, g.placements)) else torch.zeros_like(s))
    mesh = leaves[0].device_mesh
    total = shd.all_reduce(torch.stack(sums), mesh, range(mesh.ndim))
    return torch.sqrt(sum(total.unbind(0)))


def _sharded_means(p, vr_placements):
    """``_adafactor_leaf``'s ``means`` for the blocks of ``p`` (and of a
    ``vr`` in ``vr_placements``): a mean over a dim no mesh dimension splits
    is the unsharded one; over a split one, the local sum all-reduced over
    the dims that split it, divided by the whole count (one rounding)."""
    from ..distributed import sharding as shd
    from ..models.layers import count

    mesh = p.device_mesh
    lay = {"p": shd.Layout(mesh, p.placements), "vr": shd.Layout(mesh, vr_placements)}
    full = {"p": tuple(p.shape), "vr": tuple(p.shape[:-1])}

    def means(x, what, dim=None, keepdim=False):
        nd = len(full[what])
        dims = list(range(nd)) if dim is None else [dim % nd]
        split = shd.shard_dims(lay[what], dims)
        if not split:
            return mean(x, dim=dim, keepdim=keepdim)
        s = torch.sum(x) if dim is None else torch.sum(x, dim=dim, keepdim=keepdim)
        s = shd.all_reduce(s, mesh, split)
        n = 1
        for d in dims:
            n *= full[what][d]
        return s / count(n, s)

    return means


def _update_sharded(cfg: OptConfig, params, grads, state):
    from torch.distributed.tensor import Replicate, Shard

    from ..distributed import sharding as shd

    gnorm = _sharded_norm(grads)
    scale = clip_scale(cfg, gnorm)
    step_dt = state["step"]
    step = step_dt.to_local() + 1
    stepf = step.float()
    p_l, g_l = tree_flatten(params)[0], tree_flatten(grads)[0]

    if cfg.kind == "adamw":
        bc1 = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device) ** stepf
        bc2 = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device) ** stepf
        for p, g, m, v in zip(p_l, g_l, tree_flatten(state["m"])[0], tree_flatten(state["v"])[0]):
            pw = _work(p, m.placements)
            _adamw_leaf(cfg, pw, _work(g, m.placements), _work(m, m.placements), _work(v, m.placements),
                        scale, bc1, bc2)
            _put_back(p, pw, m.placements)
    elif cfg.kind == "adafactor":
        decay = 1.0 - stepf**-0.8
        for p, g, vr, vc in zip(p_l, g_l, tree_flatten(state["vr"])[0], tree_flatten(state["vc"])[0]):
            nd = p.dim()
            pp = tuple(p.placements)
            if _factored(cfg, p):  # vr drops the last dim, vc the one before
                vr_pl = tuple(Replicate() if x.is_shard() and x.dim == nd - 1 else x for x in pp)
                vc_pl = tuple(Replicate() if x.is_shard() and x.dim == nd - 2
                              else Shard(nd - 2) if x.is_shard() and x.dim == nd - 1 else x for x in pp)
            else:
                vr_pl, vc_pl = pp, tuple(vc.placements)
            vrw, vcw = _work(vr, vr_pl), _work(vc, vc_pl)
            _adafactor_leaf(cfg, p.to_local(), _work(g, pp), vrw, vcw, scale, decay,
                            means=_sharded_means(p, vr_pl), factored=_factored(cfg, p))
            _put_back(vr, vrw, vr_pl)
            _put_back(vc, vcw, vc_pl)
    else:
        raise ValueError(cfg.kind)
    state["step"] = shd.dtensor(step, shd.Layout(step_dt.device_mesh, step_dt.placements), ())
    return params, state, {"grad_norm": gnorm}
