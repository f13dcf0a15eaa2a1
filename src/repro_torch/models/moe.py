"""Mixture-of-Experts MLP with capacity-bounded sorted dispatch: the JAX
package's ``models/moe.py`` on its default path.

Tokens are ranked within their routed expert (stable sort), clipped at the
capacity ``C``, gathered into a dense (E, C, D) tensor, pushed through the
per-expert SwiGLU weights with one batched product and combined back
weighted by the router gate.  Capacity overflow drops tokens, exactly as
the reference drops them:

  * top-k keeps the lower expert index on a tie (``jax.lax.top_k``): a
    stable descending sort makes that choice explicit;
  * the dispatch order is a stable sort by expert id;
  * ``C = max(1, int(round(TK / E * capacity_factor)))`` rounds half to
    even, as Python does on both sides (at decode with 2 tokens, top-2 and
    8 experts C is 1);
  * the reference's two ``mode="drop"`` scatters write into one scratch row
    that is sliced away.

The reference's ``moe_decode_gather`` branch and its sharding hints are
perf-flag paths and wait with the flags.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .layers import normal


class MoEParams(NamedTuple):
    router: torch.Tensor  # (D, E) f32
    w_gate: torch.Tensor  # (E, D, F)
    w_up: torch.Tensor  # (E, D, F)
    w_down: torch.Tensor  # (E, F, D)


class Routing(NamedTuple):
    """What ``apply`` decided for its T tokens: ``probs`` (T, E) f32,
    ``eids`` / ``gate_vals`` (T, k) (renormalised), the aux loss, and in
    dispatch order (TK = T * k entries sorted stably by expert) the token
    ``tok_s``, gate ``gate_s``, ``keep`` (rank within the expert < C) and
    ``slot`` (``expert * C + rank``, or ``E * C`` where dropped)."""

    probs: torch.Tensor
    eids: torch.Tensor
    gate_vals: torch.Tensor
    aux: torch.Tensor
    tok_s: torch.Tensor
    gate_s: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    capacity: int


def init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int, dtype, device) -> MoEParams:
    s_in = d_model**-0.5
    s_out = d_ff**-0.5
    return MoEParams(
        router=normal(gen, (d_model, n_experts), s_in, torch.float32, device),
        w_gate=normal(gen, (n_experts, d_model, d_ff), s_in, dtype, device),
        w_up=normal(gen, (n_experts, d_model, d_ff), s_in, dtype, device),
        w_down=normal(gen, (n_experts, d_ff, d_model), s_out, dtype, device),
    )


def route(p: MoEParams, xf: torch.Tensor, *, top_k: int, capacity_factor: float) -> Routing:
    """Router, top-k, aux loss and the capacity-clipped dispatch of the
    tokens ``xf`` (T, D)."""
    logits = xf.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    # top-k, ties to the lower index (jax.lax.top_k)
    eids = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :top_k]
    return dispatch(probs, eids, capacity_factor)


def dispatch(probs: torch.Tensor, eids: torch.Tensor, capacity_factor: float) -> Routing:
    """The gates, aux loss and capacity-clipped dispatch of the top-k
    decisions ``eids`` (T, k) over the router's ``probs`` (T, E)."""
    T, E = probs.shape
    top_k = eids.shape[1]
    gate_vals = torch.gather(probs, 1, eids)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # aux loss (Switch-style): E * sum_e fraction_tokens_e * mean_prob_e
    frac = F.one_hot(eids[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(frac * probs.mean(dim=0))

    # ---- sorted dispatch ---------------------------------------------------
    TK = T * top_k
    flat_eid = eids.reshape(TK)
    flat_tok = torch.arange(T, device=probs.device).repeat_interleave(top_k)
    order = torch.sort(flat_eid, stable=True).indices
    eid_s = flat_eid[order]
    # rank within expert: position - index of the expert group's first entry
    pos = torch.arange(TK, device=probs.device)
    is_first = torch.ones(TK, dtype=torch.bool, device=probs.device)
    is_first[1:] = eid_s[1:] != eid_s[:-1]
    group_start = torch.cummax(torch.where(is_first, pos, 0), dim=0).values
    rank = pos - group_start
    C = max(1, int(round(TK / E * capacity_factor)))
    keep = rank < C
    slot = torch.where(keep, eid_s * C + rank, E * C)  # E*C: dropped
    return Routing(probs, eids, gate_vals, aux, flat_tok[order], gate_vals.reshape(TK)[order], keep, slot, C)


def apply(
    p: MoEParams,
    x: torch.Tensor,  # (B, S, D)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D), aux load-balance loss scalar)."""
    B, S, D = x.shape
    E = p.router.shape[1]
    T = B * S
    xf = x.reshape(T, D)
    r = route(p, xf, top_k=top_k, capacity_factor=capacity_factor)
    EC = E * r.capacity

    # the dropped entries land in the scratch row EC, sliced away
    gathered = torch.zeros((EC + 1, D), dtype=x.dtype, device=x.device)
    gathered[r.slot] = xf[r.tok_s]
    gathered = gathered[:EC].reshape(E, r.capacity, D)

    # ---- per-expert SwiGLU --------------------------------------------------
    g = torch.bmm(gathered, p.w_gate)
    u = torch.bmm(gathered, p.w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    y = torch.bmm(h, p.w_down).reshape(EC, D)

    # ---- weighted combine ---------------------------------------------------
    contrib = y[torch.clamp(r.slot, max=EC - 1)] * r.gate_s[:, None].to(x.dtype)
    out = torch.zeros((T + 1, D), dtype=torch.float32, device=x.device)
    out.index_add_(0, torch.where(r.keep, r.tok_s, T), contrib.float())
    return out[:T].to(x.dtype).reshape(B, S, D), r.aux
