"""The train step of the port: loss -> backward -> (compression) ->
optimizer, with microbatch gradient accumulation (the JAX package's
``training/train_step.py`` in plain PyTorch).

Microbatching bounds activation memory: each microbatch's forward and
backward run alone, its gradients are added into an f32 accumulator, and
the sum is divided by the count.  The
reference's ``lax.scan`` over ``dynamic_slice``s of the batch is a Python
loop over slices here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from ..checkpoint.manager import tree_flatten, tree_unflatten
from ..configs.base import ArchConfig
from ..models import lm
from ..models.layers import count
from . import compress, optimizer


@dataclass(frozen=True)
class TrainConfig:
    opt: optimizer.OptConfig = field(default_factory=optimizer.OptConfig)
    microbatches: int = 1
    grad_compression: bool = False


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


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig):
    """Builds ``train_step(state, batch) -> (state, metrics)``.

    ``state = {params, opt, (err)}``; ``batch = {tokens|embeds, labels}``,
    tensors on the state's device with a leading global-batch dimension
    divisible by ``microbatches`` (``None`` for the absent input).  The
    state is donated: its tensors take the new values in place (the
    reference jits the step with ``donate_argnums=(0,)``).  Metrics:
    ``loss``, ``ce``, ``aux`` (with microbatches, ``ce`` is the mean loss and
    ``aux`` 0, as the reference reports them) and ``grad_norm``.

    The reference's ``grad_shardings`` pins each microbatch's gradients and
    the accumulator to the parameters' shardings; on one card there is
    nothing to pin, so the argument is left out until the port shards.
    """
    n_mb = tcfg.microbatches

    def mb_slice(x, i):
        n = x.shape[0] // n_mb
        return x[i * n : (i + 1) * n]

    def train_step(state, batch):
        params = state["params"]
        if n_mb == 1:
            loss, parts, grads = _value_and_grad(cfg, params, batch)
        else:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in tree_flatten(params)[0]]
            loss = torch.zeros((), dtype=torch.float32, device=acc[0].device)
            for i in range(n_mb):
                mb = {k: (None if v is None else mb_slice(v, i)) for k, v in batch.items()}
                l, _, g = _value_and_grad(cfg, params, mb)
                for a, gi in zip(acc, tree_flatten(g)[0]):
                    a.add_(gi.float())
                del g
                loss = loss + l
            n = count(n_mb, loss)  # a 0-d divisor: one rounding on the card too
            grads = tree_unflatten(params, [a.div_(n) for a in acc])
            loss = loss / n
            parts = {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=loss.device)}

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


def init_state(cfg: ArchConfig, tcfg: TrainConfig, seed: int | torch.Generator = 0, device=None) -> Dict[str, Any]:
    """Fresh params (``lm.init`` from ``seed``), zero optimizer state and,
    with compression, zero error feedback, on ``device`` (``None``: the
    card)."""
    params = lm.init(cfg, seed, device=device)
    state = {"params": params, "opt": optimizer.init(tcfg.opt, params)}
    if tcfg.grad_compression:
        state["err"] = compress.init_error(params)
    return state
