"""The LM zoo of the port: the JAX package's ``models/lm.py`` in plain
PyTorch, one composable stack for the ten configs of ``configs/``.

Layers are grouped into superblocks of the config's pattern period; the
parameters of each slot of the superblock are stacked with a leading group
dimension, exactly as the reference lays them out, and the reference's
``lax.scan`` over groups is a Python loop here.  Caches are stacked the same
way (``{"slots": [...]}``, one entry per slot):

  * full attention   — (G, B, Smax, Hkv, hd) k/v, write cursor = pos
  * window attention — (G, B, window, Hkv, hd) ring (slot = pos % window;
    RoPE is applied at insert)
  * chunked attention— (G, B, chunk, ...) ring; slots <= pos % chunk are the
    live current-chunk entries
  * mamba            — (G, B, H, P, N) state + conv tail

The ring caches line up with a prefill only when the prompt fits in the
ring (the reference's own limit; ``tests/test_arch_smoke.py`` says so).

Training runs ``loss_fn`` under autograd.  With ``cfg.remat == "block"``
each group of the loop is recomputed in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of the
superblock), so only the groups' inputs stay saved; it changes no number.
Each stacked parameter is unbound into its groups once, so a group's
gradient lands in its slice of the stacked leaf's gradient.

Under a mesh (``training/train_step.py`` with ``grad_shardings``) a
parameter leaf may be a ``distributed.sharding.Sharded`` block: the
embedding, the final norm and the head are gathered at the start, each
superblock group's leaves inside the group's remat (freed after the group,
gathered again in its recomputation), and autograd reduces each gradient
back into its block.  Under ``sharding.batch_parallel`` with more than one
batch rank, the MoE layer all-gathers its input over the batch axes and
dispatches the global token set, as the reference's GSPMD program
dispatches the whole microbatch; the loss divides the local token losses'
sum by the global count.

Everything runs on the tensors' device; ``init`` and ``init_cache`` take a
``device``, and ``device=None`` means the CUDA card (it raises without
one).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..distributed.sharding import Sharded, batch_ranks, batch_rows, batch_sum, gather_batch, unshard, unshard_tree
from . import mamba as mamba_mod
from . import moe as moe_mod
from .layers import PERF_FLAGS, blockwise_attention, cross_entropy, decode_attention, normal, rms_norm, rope, swiglu

DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _dense(gen, shape, scale, device):
    return normal(gen, shape, scale, DTYPE, device)


def _slot_init(cfg: ArchConfig, slot: int, gen: torch.Generator, device) -> Dict[str, Any]:
    D = cfg.d_model
    hd = cfg.head_dim_
    p: Dict[str, Any] = {"ln1": torch.ones((D,), dtype=DTYPE, device=device)}
    if cfg.layer_kind(slot) == "attn":
        p["attn"] = {
            "wq": _dense(gen, (D, cfg.n_heads * hd), D**-0.5, device),
            "wk": _dense(gen, (D, cfg.n_kv_heads * hd), D**-0.5, device),
            "wv": _dense(gen, (D, cfg.n_kv_heads * hd), D**-0.5, device),
            "wo": _dense(gen, (cfg.n_heads * hd, D), (cfg.n_heads * hd) ** -0.5, device),
        }
    else:
        p["mamba"] = mamba_mod.init(
            gen, D, expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim, state=cfg.ssm_state,
            conv=cfg.ssm_conv, dtype=DTYPE, device=device,
        )._asdict()
    mk = cfg.mlp_kind(slot)
    if mk != "none":
        p["ln2"] = torch.ones((D,), dtype=DTYPE, device=device)
    if mk == "dense":
        F_ = cfg.d_ff
        p["mlp"] = {
            "w_gate": _dense(gen, (D, F_), D**-0.5, device),
            "w_up": _dense(gen, (D, F_), D**-0.5, device),
            "w_down": _dense(gen, (F_, D), F_**-0.5, device),
        }
    elif mk == "moe":
        p["moe"] = moe_mod.init(gen, D, cfg.d_ff, cfg.n_experts, DTYPE, device)._asdict()
        if cfg.shared_expert:
            F_ = cfg.d_ff
            p["shared_mlp"] = {
                "w_gate": _dense(gen, (D, F_), D**-0.5, device),
                "w_up": _dense(gen, (D, F_), D**-0.5, device),
                "w_down": _dense(gen, (F_, D), F_**-0.5, device),
            }
    return p


def _stack(trees):
    """Stack a list of equal dict trees of tensors along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees, dim=0)


def _stacked_init(cfg: ArchConfig, slot: int, groups: int, gen: torch.Generator, device):
    """``_slot_init`` for each group, stacked along a new axis 0: each
    group's tree is copied in as it is drawn, so the transient is one
    group's parameters."""

    def alloc(t):
        return {k: alloc(v) for k, v in t.items()} if isinstance(t, dict) else t.new_empty((groups, *t.shape))

    def put(dst, src, g):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, g)
            else:
                dst[k][g] = v

    first = _slot_init(cfg, slot, gen, device)
    out = alloc(first)
    put(out, first, 0)
    del first
    for g in range(1, groups):
        put(out, _slot_init(cfg, slot, gen, device), g)
    return out


def _at(tree, g: int):
    """Group ``g`` of a stacked tree (views, no copy; a ``Sharded`` leaf's
    group gathered)."""
    if isinstance(tree, dict):
        return {k: _at(v, g) for k, v in tree.items()}
    return unshard(tree.group(g)) if isinstance(tree, Sharded) else tree[g]


def _groups(tree, n: int):
    """The ``n`` groups of a stacked tree, each leaf unbound once (views, no
    copy; under autograd one node a leaf gathers the groups' gradients)."""
    if isinstance(tree, dict):
        parts = {k: _groups(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    if isinstance(tree, Sharded):  # gathered where the group runs
        return [tree.group(g) for g in range(n)]
    return list(torch.unbind(tree, dim=0))


def init(cfg: ArchConfig, seed: int | torch.Generator = 0, device=None) -> Dict[str, Any]:
    """Random bf16 parameters (norms ones, the MoE router f32), drawn from
    ``seed`` (an int or a ``torch.Generator`` on ``device``).  Each slot's
    parameters are stacked over the ``n_layers // superblock`` groups."""
    device = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator(device=device).manual_seed(seed)
    period = cfg.superblock
    groups = cfg.n_layers // period
    blocks = [_stacked_init(cfg, slot, groups, gen, device) for slot in range(period)]
    return {
        "embed": _dense(gen, (cfg.vocab_size, cfg.d_model), 1.0, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=DTYPE, device=device),
        "lm_head": _dense(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model**-0.5, device),
        "blocks": blocks,
    }


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def cache_spec(cfg: ArchConfig, batch: int, max_len: int) -> Dict[str, Any]:
    """The cache tree as ``(shape, dtype)`` leaves; ``init_cache`` fills it
    with zeros."""
    period = cfg.superblock
    groups = cfg.n_layers // period
    hd = cfg.head_dim_
    slots = []
    for slot in range(period):
        if cfg.layer_kind(slot) == "attn":
            flavor = cfg.attn_flavor(slot)
            if flavor == "window":
                S = min(cfg.window, max_len)
            elif flavor == "chunk":
                S = min(cfg.chunk, max_len)
            else:
                S = max_len
            kv = ((groups, batch, S, cfg.n_kv_heads, hd), DTYPE)
            slots.append({"k": kv, "v": kv})
        else:
            d_in, H = mamba_mod.dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_state)
            slots.append({
                "h": ((groups, batch, H, cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
                "conv": ((groups, batch, cfg.ssm_conv - 1, d_in + 2 * cfg.ssm_state), DTYPE),
            })
    return {"slots": slots}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    device = resolve_device(device)
    spec = cache_spec(cfg, batch, max_len)
    return {"slots": [{k: torch.zeros(shape, dtype=dt, device=device) for k, (shape, dt) in s.items()}
                      for s in spec["slots"]]}


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    """``table[ids]`` whose backward sums each row's gradients in f32 and
    rounds the sum once to the table's dtype.  Autograd's own backward of
    the indexing adds them in the table's dtype: with a bf16 table and a
    zipf token stream (one id 2,472 times in 2 x 4096 tokens) the most
    frequent row's gradient came out 12 % off its exact sum.  The sum runs
    over the distinct ids through ``index_put_(accumulate=True)``, which
    sorts its indices on the card and so adds in the same order every run."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        if g.device.type == "meta":  # shapes only (the dry run): ``unique`` has none to give
            return g.new_empty(ctx.table_shape, dtype=ctx.table_dtype), None
        rows, inv = torch.unique(ids.reshape(-1), return_inverse=True)
        acc = torch.zeros((rows.numel(), *g.shape[ids.dim():]), dtype=torch.float32, device=g.device)
        acc.index_put_((inv,), g.reshape(-1, *acc.shape[1:]).float(), accumulate=True)
        out = torch.zeros(ctx.table_shape, dtype=ctx.table_dtype, device=g.device)
        out[rows] = acc.to(ctx.table_dtype)
        return out, None


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` as JAX gathers it: a negative id counts from the
    end, then ids are clamped into the table.  Its gradient is summed in
    f32 (``_Gather``)."""
    V = table.shape[0]
    tokens = tokens.long()
    return _Gather.apply(table, torch.where(tokens < 0, tokens + V, tokens).clamp(0, V - 1))


def _proj(h, w):
    return torch.einsum("bsd,dh->bsh", h, w)


def _attn_layer(cfg, slot, p, x, positions, mode):
    B, S, D = x.shape
    hd = cfg.head_dim_
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = _proj(h, p["attn"]["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = _proj(h, p["attn"]["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = _proj(h, p["attn"]["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    flavor = cfg.attn_flavor(slot)
    o = blockwise_attention(q, k, v, causal=cfg.causal, flavor=flavor, window=cfg.window, chunk=cfg.chunk)
    o = _proj(o.reshape(B, S, -1), p["attn"]["wo"])
    new_cache = None
    if mode == "prefill":
        if flavor == "window":
            W = min(cfg.window, S)
            new_cache = {"k": k[:, -W:], "v": v[:, -W:]}
        elif flavor == "chunk":
            C = min(cfg.chunk, S)
            new_cache = {"k": k[:, -C:], "v": v[:, -C:]}
        else:
            new_cache = {"k": k, "v": v}
    return x + o, new_cache


def _mamba_kw(cfg):
    return dict(expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim, state=cfg.ssm_state, conv=cfg.ssm_conv)


def _mamba_layer(cfg, p, x, mode):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mp = mamba_mod.MambaParams(**p["mamba"])
    if mode == "prefill":
        o, st = mamba_mod.apply_scan(mp, h, return_state=True, **_mamba_kw(cfg))
        return x + o, {"h": st.h, "conv": st.conv}
    return x + mamba_mod.apply_scan(mp, h, **_mamba_kw(cfg)), None


def _mlp_layer(cfg, slot, p, x):
    mk = cfg.mlp_kind(slot)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if mk == "none":
        return x, zero
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if mk == "dense":
        return x + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"]), zero
    # the global dispatch: every batch rank's tokens, this rank's rows kept
    out, aux = moe_mod.apply(
        moe_mod.MoEParams(**p["moe"]), gather_batch(h), top_k=cfg.experts_per_token,
        capacity_factor=cfg.capacity_factor,
        combine_dtype=torch.bfloat16 if PERF_FLAGS.get("moe_bf16_combine") else torch.float32,
    )
    out = batch_rows(out)
    if cfg.shared_expert:
        out = out + swiglu(h, p["shared_mlp"]["w_gate"], p["shared_mlp"]["w_up"], p["shared_mlp"]["w_down"])
    return x + out, aux


def forward(
    cfg: ArchConfig,
    params: Dict[str, Any],
    tokens: Optional[torch.Tensor] = None,  # (B, S) int
    embeds: Optional[torch.Tensor] = None,  # (B, S, D) for stubbed frontends
    mode: str = "train",  # train | prefill
):
    """Returns (logits, aux_loss, cache_or_None)."""
    if (tokens is None) == (embeds is None):
        raise ValueError("pass exactly one of tokens and embeds")
    x = _embed(unshard(params["embed"]), tokens) if embeds is None else embeds.to(DTYPE)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].repeat(B, 1)
    period = cfg.superblock
    want_cache = mode == "prefill"
    groups = params["blocks"][0]["ln1"].shape[0]

    def superblock(x, aux, slot_params):
        slot_params = [unshard_tree(p) for p in slot_params]  # a mesh's blocks, gathered here
        caches = []
        for slot in range(period):
            p = slot_params[slot]
            if cfg.layer_kind(slot) == "attn":
                x, c = _attn_layer(cfg, slot, p, x, positions, mode)
            else:
                x, c = _mamba_layer(cfg, p, x, mode)
            x, a = _mlp_layer(cfg, slot, p, x)
            aux = aux + a
            caches.append(c)
        return x, aux, caches

    remat = cfg.remat == "block" and mode == "train" and torch.is_grad_enabled()
    per_group = [_groups(b, groups) for b in params["blocks"]]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = [[] for _ in range(period)]
    for g in range(groups):
        slot_params = [per_group[slot][g] for slot in range(period)]
        if remat:
            x, aux, cs = checkpoint(superblock, x, aux, slot_params, use_reentrant=False)
        else:
            x, aux, cs = superblock(x, aux, slot_params)
        for slot, c in enumerate(cs):
            caches[slot].append(c)
    x = rms_norm(x, unshard(params["final_norm"]), cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, unshard(params["lm_head"]))
    cache = {"slots": [_stack(c) for c in caches]} if want_cache else None
    return logits, aux, cache


def loss_fn(cfg: ArchConfig, params: Dict[str, Any], batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal LM loss (decoders: logits at ``t`` against labels at ``t+1``)
    or masked-unit prediction (encoders: labels at ``t``).  ``batch`` holds
    ``labels`` and ``tokens`` or ``embeds``.  Returns ``(ce + 0.01 * aux,
    {"ce", "aux"})``.

    Under ``sharding.batch_parallel`` over R > 1 ranks this rank's share:
    ``ce`` is its token losses' sum over the global token count (the
    all-reduced local counts) and the aux loss, which every rank computes
    whole from the global dispatch, enters the total as ``aux / R``; the
    ranks' totals and gradients sum to the global ones."""
    logits, aux, _ = forward(cfg, params, tokens=batch.get("tokens"), embeds=batch.get("embeds"), mode="train")
    labels = batch["labels"]
    if cfg.causal:
        logits, labels = logits[:, :-1], labels[:, 1:]
    R = batch_ranks()
    if R == 1:
        ce = cross_entropy(logits, labels)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}
    total = batch_sum(torch.full((), float(labels.numel()), dtype=torch.float32, device=labels.device))
    ce = cross_entropy(logits, labels, total=total)
    return ce + 0.01 * (aux / R), {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _ring_index(flavor: str, pos: int, Smax: int):
    """(write slot, live length) of position ``pos`` in a cache of ``Smax``."""
    if flavor == "window":
        return pos % Smax, min(pos + 1, Smax)
    if flavor == "chunk":
        return pos % Smax, pos % Smax + 1
    return pos, pos + 1


def decode_step(
    cfg: ArchConfig,
    params: Dict[str, Any],
    cache: Dict[str, Any],
    token: torch.Tensor,  # (B,) int (or (B, D) embeds for stub frontends)
    pos: int,  # current position
):
    """One autoregressive step.  Returns (logits (B,V), new cache); the
    cache passed in is left as it was."""
    pos = int(pos)
    x = _embed(unshard(params["embed"]), token)[:, None, :] if token.dim() == 1 else token[:, None, :].to(DTYPE)
    B = x.shape[0]
    hd = cfg.head_dim_
    period = cfg.superblock
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    groups = params["blocks"][0]["ln1"].shape[0]

    new_slots = []
    for slot in range(period):
        c = cache["slots"][slot]
        if cfg.layer_kind(slot) == "attn":
            new_slots.append({"k": c["k"].clone(), "v": c["v"].clone()})
        else:
            new_slots.append({"h": torch.empty_like(c["h"]), "conv": torch.empty_like(c["conv"])})
    for g in range(groups):
        for slot in range(period):
            p = _at(params["blocks"][slot], g)
            nc = new_slots[slot]
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            if cfg.layer_kind(slot) == "attn":
                q = _proj(h, p["attn"]["wq"]).reshape(B, 1, cfg.n_heads, hd)
                k = _proj(h, p["attn"]["wk"]).reshape(B, 1, cfg.n_kv_heads, hd)
                v = _proj(h, p["attn"]["wv"]).reshape(B, 1, cfg.n_kv_heads, hd)
                q = rope(q, positions, cfg.rope_theta)
                k = rope(k, positions, cfg.rope_theta)
                Smax = nc["k"].shape[2]
                idx, valid = _ring_index(cfg.attn_flavor(slot), pos, Smax)
                # dynamic_update_slice clamps its start into the cache
                idx = min(max(idx, 0), Smax - 1)
                nc["k"][g, :, idx] = k[:, 0]
                nc["v"][g, :, idx] = v[:, 0]
                o = decode_attention(q, nc["k"][g], nc["v"][g], valid)
                x = x + _proj(o.reshape(B, 1, -1), p["attn"]["wo"])
            else:
                c = cache["slots"][slot]
                o, st = mamba_mod.apply_step(
                    mamba_mod.MambaParams(**p["mamba"]), h,
                    mamba_mod.MambaState(h=c["h"][g], conv=c["conv"][g]), **_mamba_kw(cfg),
                )
                x = x + o
                nc["h"][g] = st.h
                nc["conv"][g] = st.conv
            x, _ = _mlp_layer(cfg, slot, p, x)
    x = rms_norm(x, unshard(params["final_norm"]), cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, unshard(params["lm_head"]))[:, 0]
    return logits, {"slots": new_slots}
