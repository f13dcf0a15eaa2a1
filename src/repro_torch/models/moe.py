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

The ``moe_decode_gather`` perf flag (``layers.set_perf_flags``) takes,
where ``T * top_k <= E``, the reference's no-drop path that gathers only
the routed experts' weights and runs a per-token SwiGLU.  Its combine adds
``top_k`` rows into each token's zero row with ``index_add_``, whose order
is free on the card: with ``top_k <= 2``, as in every config, the sum is
exact in any order.

``combine_dtype`` (the ``moe_bf16_combine`` flag, through ``models/lm.py``)
is the reference's: with bf16 the weighted rows are added into bf16 token
rows, rounding after each add in dispatch order, as XLA's scatter adds
them.  ``index_add_`` does not: on the CPU it sums a row's bf16 updates in
f32 and rounds once, on the card its atomic adds come in any order.  So the
combine runs ``top_k`` passes, pass ``j`` adding each token's ``j``-th
entry in dispatch order (the others add exact zeros), one rounding an add
in the reference's order on every device.  The reference's layout hints on
the MoE activations (``moe_gathered_shard``, ``moe_decode_local``,
``moe_y_shard``) are refused by ``layers.set_perf_flags``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .layers import PERF_FLAGS, mean, normal


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


def _router(p: MoEParams, xf: torch.Tensor, top_k: int):
    """The router's probabilities (T, E) f32 and the top-k expert ids (T, k)
    of the tokens ``xf`` (T, D)."""
    logits = xf.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    # top-k, ties to the lower index (jax.lax.top_k)
    return probs, torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :top_k]


def _gates_and_aux(probs: torch.Tensor, eids: torch.Tensor):
    """The renormalised gates (T, k) and the aux loss (Switch-style:
    E * sum_e fraction_tokens_e * mean_prob_e, over the first choices)."""
    E = probs.shape[1]
    gate_vals = torch.gather(probs, 1, eids)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    frac = mean(F.one_hot(eids[:, 0], E).float(), dim=0)
    return gate_vals, E * torch.sum(frac * mean(probs, dim=0))


def route(p: MoEParams, xf: torch.Tensor, *, top_k: int, capacity_factor: float) -> Routing:
    """Router, top-k, aux loss and the capacity-clipped dispatch of the
    tokens ``xf`` (T, D)."""
    return dispatch(*_router(p, xf, top_k), capacity_factor)


def dispatch(probs: torch.Tensor, eids: torch.Tensor, capacity_factor: float) -> Routing:
    """The gates, aux loss and capacity-clipped dispatch of the top-k
    decisions ``eids`` (T, k) over the router's ``probs`` (T, E)."""
    T, E = probs.shape
    top_k = eids.shape[1]
    gate_vals, aux = _gates_and_aux(probs, eids)

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


def decode_gather(p: MoEParams, xf: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``moe_decode_gather`` path for a few tokens ``xf`` (T, D): only
    the routed experts' weights are gathered (T*k rows of each), a
    per-token SwiGLU with the SiLU in f32, the gated rows summed in f32
    into each token's zero row.  No token is dropped.  Returns (out (T, D)
    f32, aux)."""
    T, D = xf.shape
    probs, eids = _router(p, xf, top_k)
    gate_vals, aux = _gates_and_aux(probs, eids)
    eflat = eids.reshape(-1)
    xt = xf.repeat_interleave(top_k, dim=0)[:, None, :]  # (Tk, 1, D)
    g = torch.bmm(xt, p.w_gate[eflat])[:, 0]  # (Tk, F): only the routed experts' weights
    u = torch.bmm(xt, p.w_up[eflat])[:, 0]
    h = F.silu(g.float()).to(xf.dtype) * u
    y = torch.bmm(h[:, None, :], p.w_down[eflat])[:, 0]  # (Tk, D)
    tok = torch.arange(T, device=xf.device).repeat_interleave(top_k)
    out = torch.zeros((T, D), dtype=torch.float32, device=xf.device)
    out.index_add_(0, tok, y.float() * gate_vals.reshape(-1, 1))
    return out, aux


def apply(
    p: MoEParams,
    x: torch.Tensor,  # (B, S, D)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    combine_dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D), aux load-balance loss scalar).
    ``combine_dtype``: the dtype the weighted expert rows are summed in
    (f32, or bf16 in the reference's dispatch order: module docstring)."""
    B, S, D = x.shape
    E = p.router.shape[1]
    T = B * S
    xf = x.reshape(T, D)
    if PERF_FLAGS.get("moe_decode_gather") and T * top_k <= E:
        out, aux = decode_gather(p, xf, top_k)
        return out.to(x.dtype).reshape(B, S, D), aux
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
    out = combine(contrib, torch.where(r.keep, r.tok_s, T), T, top_k, combine_dtype)
    return out.to(x.dtype).reshape(B, S, D), r.aux


def combine(contrib: torch.Tensor, tgt: torch.Tensor, T: int, top_k: int, dtype=torch.float32) -> torch.Tensor:
    """The (T, D) sum of the rows ``contrib`` (TK, D), in dispatch order,
    into their target rows ``tgt`` (``T``: dropped), in ``dtype``: f32 in
    one ``index_add_``, another dtype in ``top_k`` ordered passes (module
    docstring)."""
    out = torch.zeros((T + 1, contrib.shape[1]), dtype=dtype, device=contrib.device)
    if dtype == torch.float32:
        out.index_add_(0, tgt, contrib.float())
        return out[:T]
    occ = _occurrence(tgt)
    zero = torch.zeros((), dtype=dtype, device=contrib.device)
    rows = contrib.to(dtype)
    for j in range(top_k):
        out.index_add_(0, tgt, torch.where((occ == j)[:, None], rows, zero))
    return out[:T]


def _occurrence(tgt: torch.Tensor) -> torch.Tensor:
    """Each entry's rank among the entries of the same target row, in entry
    order (the rank-within-expert of ``dispatch``, by row)."""
    order = torch.sort(tgt, stable=True).indices
    t = tgt[order]
    pos = torch.arange(t.numel(), device=t.device)
    is_first = torch.ones_like(t, dtype=torch.bool)
    is_first[1:] = t[1:] != t[:-1]
    rank = pos - torch.cummax(torch.where(is_first, pos, 0), dim=0).values
    return torch.empty_like(rank).scatter_(0, order, rank)
