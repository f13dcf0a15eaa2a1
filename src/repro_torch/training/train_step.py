"""The train step of the port: loss -> backward -> (compression) ->
optimizer, with microbatch gradient accumulation (the JAX package's
``training/train_step.py`` in plain PyTorch).

Microbatching bounds activation memory: each microbatch's forward and
backward run alone, its gradients are added into an accumulator
(``TrainConfig.accum_dtype``: f32, or bf16 as the reference's dry run sets
it above 1e11 parameters), and the sum is divided by the count.  The
reference's ``lax.scan`` over ``dynamic_slice``s of the batch is a Python
loop over slices here.

With ``grad_shardings`` the step runs on a mesh (``distributed/sharding.py``):
the state's leaves are DTensors in the reference's placements, the batch
is split over the batch axes, each rank computes its rows data parallel
(parameters gathered a superblock group at a time, gradients reduced back
into the parameters' placements, the pin the reference's ``grad_shardings``
stands for), and the accumulator and the optimizer work on the blocks.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from ..checkpoint.manager import tree_flatten, tree_unflatten
from ..configs.base import ArchConfig
from ..distributed import sharding as shd
from ..models import lm
from ..models.layers import count
from . import compress, optimizer


@dataclass(frozen=True)
class TrainConfig:
    opt: optimizer.OptConfig = field(default_factory=optimizer.OptConfig)
    microbatches: int = 1
    grad_compression: bool = False
    # f32 is the safe default; the >=100B configs accumulate in bf16
    accum_dtype: str = "float32"


def _value_and_grad(cfg: ArchConfig, params, batch):
    """(total, parts, grads) of ``lm.loss_fn`` at ``params``: the gradient
    of each leaf in the leaf's dtype, zeros where the loss does not reach
    it (as ``jax.value_and_grad`` gives them).  ``params`` themselves never
    require gradients: the loss runs on detached aliases of them."""
    leaves, _ = tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        total, parts = lm.loss_fn(cfg, tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(total, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return total.detach(), {k: v.detach() for k, v in parts.items()}, tree_unflatten(params, grads)


def _value_and_grad_sharded(cfg: ArchConfig, params, layouts, batch):
    """``_value_and_grad`` on a mesh: ``params`` DTensors, ``batch`` this
    rank's rows, under ``sharding.batch_parallel``.  The loss runs on
    ``Sharded`` aliases of the blocks; the gradients come back as blocks in
    ``layouts`` (already reduced over the batch ranks), the loss and ``ce``
    summed over them (``aux`` is every rank's)."""
    leaves, _ = tree_flatten(params)
    live = [p.to_local().detach().requires_grad_() for p in leaves]
    tree = tree_unflatten(params, [shd.Sharded(x, lay, p.shape) for x, lay, p in zip(live, layouts, leaves)])
    with torch.enable_grad():
        total, parts = lm.loss_fn(cfg, tree, batch)
        grads = torch.autograd.grad(total, live, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(live, grads)]
    parts = {k: v.detach() for k, v in parts.items()}
    total = total.detach()
    if shd.batch_ranks() > 1:
        parts["ce"] = shd.batch_sum(parts["ce"])
        total = parts["ce"] + 0.01 * parts["aux"]
    return total, parts, grads


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig, grad_shardings=None):
    """Builds ``train_step(state, batch) -> (state, metrics)``.

    ``state = {params, opt, (err)}``; ``batch = {tokens|embeds, labels}``,
    tensors on the state's device with a leading global-batch dimension
    divisible by ``microbatches`` (``None`` for the absent input).  The
    state is donated: its tensors take the new values in place (the
    reference jits the step with ``donate_argnums=(0,)``).  Metrics:
    ``loss``, ``ce``, ``aux`` (with microbatches, ``ce`` is the mean loss and
    ``aux`` 0, as the reference reports them) and ``grad_norm``.

    ``grad_shardings`` (the reference's argument): ``None`` for one device,
    or a tree like the params of ``sharding.Layout`` (``launch/train.py``'s
    ``build`` makes it from ``param_specs``).  Then the state's leaves are
    DTensors in the placements of ``param_specs`` / ``opt_specs`` (``err``
    like the params) and the batch's are DTensors split over the batch
    axes as ``sharding.shard_batch`` lays them out (microbatch ``i`` is the
    ``i``-th piece of every rank's rows); each microbatch's gradients come
    back in the parameters' placements and are accumulated there.
    """
    n_mb = tcfg.microbatches
    adt = getattr(torch, tcfg.accum_dtype)
    layouts = None if grad_shardings is None else tree_flatten(grad_shardings)[0]

    def mb_slice(x, i):
        n = x.shape[0] // n_mb
        return x[i * n : (i + 1) * n]

    def grads_of(params, batch):
        if layouts is None:
            loss, parts, g = _value_and_grad(cfg, params, batch)
            return loss, parts, tree_flatten(g)[0]
        return _value_and_grad_sharded(cfg, params, layouts, batch)

    def accumulate(params, batch):
        if n_mb == 1:
            return grads_of(params, batch)
        acc = None
        for i in range(n_mb):
            mb = {k: (None if v is None else mb_slice(v, i)) for k, v in batch.items()}
            l, _, g = grads_of(params, mb)
            if acc is None:
                acc = [torch.zeros(x.shape, dtype=adt, device=x.device) for x in g]
                loss = torch.zeros((), dtype=torch.float32, device=l.device)
            for a, gi in zip(acc, g):
                a.add_(gi.to(adt))
            del g
            loss = loss + l
        n = count(n_mb, loss)  # a 0-d divisor: one rounding on the card too
        loss = loss / n
        grads = [a.div_(count(n_mb, a)) for a in acc]
        return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=loss.device)}, grads

    def train_step(state, batch):
        params = state["params"]
        if layouts is None:
            loss, parts, grads = accumulate(params, batch)
            grads = tree_unflatten(params, grads)
        else:
            local = {k: (v.to_local() if hasattr(v, "to_local") else v) for k, v in batch.items()}
            mesh = layouts[0].mesh
            with shd.collectives(mesh), shd.batch_parallel(mesh):
                loss, parts, grads = accumulate(params, local)
            grads = tree_unflatten(params, [shd.dtensor(g, lay, p.shape)
                                            for g, lay, p in zip(grads, layouts, tree_flatten(params)[0])])

        with shd.collectives(layouts[0].mesh) if layouts else contextlib.nullcontext():
            new_err = state.get("err")
            if tcfg.grad_compression:
                grads, new_err = compress.compress_tree(grads, state["err"])
            new_params, new_opt, om = optimizer.update(tcfg.opt, params, grads, state["opt"])
        del grads
        new_state = {"params": new_params, "opt": new_opt}
        if new_err is not None:
            new_state["err"] = new_err
        return new_state, {"loss": loss, **parts, **om}

    return train_step


def init_state(cfg: ArchConfig, tcfg: TrainConfig, seed: int | torch.Generator = 0, device=None,
               shardings=None) -> Dict[str, Any]:
    """Fresh params (``lm.init`` from ``seed``), zero optimizer state and,
    with compression, zero error feedback, on ``device`` (``None``: the
    card).  ``shardings`` (a state tree of ``sharding.Layout``, as
    ``launch/train.py``'s ``build`` returns it): every rank draws the whole
    state from the seed and keeps its blocks, as DTensors."""
    params = lm.init(cfg, seed, device=device)
    state = {"params": params, "opt": optimizer.init(tcfg.opt, params)}
    if tcfg.grad_compression:
        state["err"] = compress.init_error(params)
    return state if shardings is None else shd.distribute_tree(state, shardings, copy=False)
