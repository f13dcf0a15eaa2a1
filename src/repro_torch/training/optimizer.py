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


def _adafactor_leaf(cfg: OptConfig, p, g, vr, vc, scale, decay) -> None:
    g = g.float() * scale
    g2 = g * g + 1e-30
    if _factored(cfg, p):
        vr.mul_(decay).add_((1 - decay) * mean(g2, dim=-1))
        vc.mul_(decay).add_((1 - decay) * mean(g2, dim=-2))
        r = vr / torch.clamp(mean(vr, dim=-1, keepdim=True), min=1e-30)
        vhat = r[..., None] * vc[..., None, :]
    else:
        vr.mul_(decay).add_((1 - decay) * g2)
        vhat = vr
    del g2
    upd = g / torch.sqrt(vhat + cfg.eps)
    del g, vhat
    # update clipping (RMS <= 1): adafactor's stabiliser
    rms = torch.sqrt(mean(torch.square(upd)) + 1e-30)
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
