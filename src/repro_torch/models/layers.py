"""Transformer building blocks of the port: the JAX package's
``models/layers.py`` in plain PyTorch.

Attention is blockwise (a running softmax over KV blocks), in three
flavours picked per layer by the config:

  * ``full``   — causal (or bidirectional for encoders) over the whole
    sequence: every KV block is scanned under a mask, or, with
    ``causal_scheme="paired"`` or the ``paired_causal`` flag, the
    triangular pair schedule;
  * ``window`` — sliding-window attention: each Q block attends to a
    fixed-width KV span ending at itself;
  * ``chunk``  — block-diagonal chunks of local attention.

The reference's ``lax.map`` / ``lax.scan`` over blocks are Python loops
here; each block does the same products in the same order.  GQA never
repeats KV heads: Q is grouped as (Hkv, G).  Scores and softmax statistics
are f32.  ``jnp.einsum`` promotes an f32 operand times a bf16 one to f32;
``torch.einsum`` refuses mixed types, so such operands are upcast
explicitly (bf16 values are exact in f32), which materialises an f32 copy
that the reference avoids (``preferred_element_type``).  Products of two
bf16 operands (projections, MLPs) stay bf16 matmuls with f32 accumulation
on both sides.

``PERF_FLAGS`` / ``set_perf_flags`` carry the reference's flags that
change what is computed: ``paired_causal`` (full causal attention takes the
paired schedule), ``block_kv`` (the KV block of ``blockwise_attention``),
``moe_decode_gather`` and ``moe_bf16_combine`` (``models/moe.py``).  The
reference's layout hints (``LAYOUT_FLAGS``) are refused by name: each is a
``with_sharding_constraint`` that changes no value and pins an activation
layout only a tensor-parallel program has, and the port's sharded step is
data parallel (``distributed/sharding.py``).  ``UNROLL_ATTN`` has no twin:
it only lets XLA's cost analysis, which counts a loop body once, see every
block; PyTorch runs and counts every block anyway.

The masked scan stays the default, as in the reference, though the paired
schedule does fewer block steps: its output and query gradient are the
masked scan's bit for bit on the CPU, but it sums the key and value
gradients over the query blocks in another order, so a training step's
numbers change in the last bits.  Which of the two a run takes is the
caller's choice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30
_DRAW = 1 << 26  # values drawn at a time by ``normal``

# the reference's perf flags that change the computation (default off)
PERF_FLAG_NAMES = ("paired_causal", "block_kv", "moe_decode_gather", "moe_bf16_combine")
# the reference's GSPMD layout hints: refused (module docstring)
LAYOUT_FLAGS = ("attn_q_shard", "attn_scores_shard", "decode_logits_shard", "moe_gathered_shard",
                "moe_decode_local", "moe_y_shard", "attn_rs", "moe_rs")
PERF_FLAGS: dict = {}


def set_perf_flags(**kw) -> None:
    """Clears the flags, then sets those of ``kw`` whose value is not
    ``None``.  A name outside ``PERF_FLAG_NAMES`` raises ``ValueError`` and
    leaves the flags as they were."""
    layout = sorted(set(kw) & set(LAYOUT_FLAGS))
    if layout:
        raise ValueError(
            f"layout flags {layout} are not ported: each pins a GSPMD activation layout of a tensor-parallel "
            "program and changes no value; the port's sharded step is data parallel and has no such layout"
        )
    unknown = sorted(set(kw) - set(PERF_FLAG_NAMES))
    if unknown:
        raise ValueError(f"unknown perf flags {unknown}: the port takes {list(PERF_FLAG_NAMES)}")
    PERF_FLAGS.clear()
    PERF_FLAGS.update({k: v for k, v in kw.items() if v is not None})


def normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """N(0, 1) * scale drawn from ``gen`` on ``device`` in f32 and cast to
    ``dtype``, in pieces of at most 2^26 values, so that a weight of several
    GB never has a whole f32 copy.  The draws depend on the generator's
    device: weights drawn on the CPU differ from those drawn on the card."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), _DRAW):
        n = min(_DRAW, flat.numel() - i)
        flat[i : i + n] = torch.randn(n, generator=gen, device=device) * scale
    return out


def _pow2(n: int) -> bool:
    return n & (n - 1) == 0


def count(n: int, like: torch.Tensor):
    """``n``, to divide ``like`` by with one rounding on every device.  A
    CUDA tensor divided by a Python number, and ``torch.mean`` on the card,
    are multiplied by the count's reciprocal: two roundings where the CPU
    rounds once.  A power of two has an exact reciprocal and stays a number
    (no launch); any other count is a 0-d tensor of ``like``'s dtype on its
    device."""
    if _pow2(n):
        return float(n)
    return torch.full((), float(n), dtype=like.dtype, device=like.device)


def mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The mean of ``x`` over ``dim`` (all of it where ``None``): the sum
    divided by the count, one rounding on every device, as ``torch.mean``
    rounds on the CPU (bit for bit).  A power-of-two count keeps
    ``torch.mean``, one kernel, whose reciprocal is then exact."""
    n = x.numel() if dim is None else x.shape[dim]
    op = torch.mean if _pow2(n) else torch.sum
    s = op(x) if dim is None else op(x, dim=dim, keepdim=keepdim)
    return s if _pow2(n) else s / count(n, s)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * w.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    ang0 = -math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(ang0 / count(half, ang0))
    ang = positions[..., :, None].float() * freqs[None, :]
    cos = torch.cos(ang)[..., :, None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


# ---------------------------------------------------------------------------
# blockwise attention
# ---------------------------------------------------------------------------


def _block_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B, bq, Hkv, G, hd) x k (B, bkv, Hkv, hd) -> (B, Hkv, G, bq, bkv), f32."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale


def _merge_block(carry, s, v):
    """Running-softmax merge. carry=(m,l,acc); s (B,Hkv,G,bq,bkv);
    v (B,bkv,Hkv,hd); acc (B,Hkv,G,bq,hd)."""
    m, l, acc = carry
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    acc = acc * alpha[..., None] + pv
    return m_new, l, acc


def _finish(m, l, acc, dtype):
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(dtype)  # (B, Hkv, G, bq, hd)


def _blocks_to_seq(outs, B, Sq, H, hd):
    """Per-Q-block outputs, each (B, Hkv, G, bq, hd) -> (B, Sq, H, hd)."""
    out = torch.stack(outs, dim=1)  # (B, nq, Hkv, G, bq, hd)
    return out.movedim(-2, 2).reshape(B, Sq, H, hd)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def blockwise_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, Hkv, hd)
    v: torch.Tensor,  # (B, Skv, Hkv, hd)
    *,
    causal: bool,
    flavor: str = "full",  # full | window | chunk
    window: int = 0,
    chunk: int = 0,
    q_offset: int = 0,  # global position of q[0] (prefill continuation)
    block_q: int = 512,
    block_kv: int = 512,
    causal_scheme: str = "masked",  # masked | paired
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    block_kv = PERF_FLAGS.get("block_kv", block_kv)
    block_q = min(block_q, Sq)
    block_kv = min(block_kv, Skv)
    if Sq % block_q or Skv % block_kv:
        raise ValueError(f"sequence lengths {Sq}, {Skv} are not multiples of the blocks {block_q}, {block_kv}")
    nq, nkv = Sq // block_q, Skv // block_kv
    qg = q.reshape(B, nq, block_q, Hkv, G, hd)
    dtype = q.dtype
    dev = q.device

    q_pos_base = torch.arange(block_q, device=dev)
    kv_pos_base = torch.arange(block_kv, device=dev)

    def mask_for(qi_start, kv_start):
        """(bq, bkv) additive mask given global block offsets."""
        qp = (q_pos_base + qi_start + q_offset)[:, None]
        kp = (kv_pos_base + kv_start)[None, :]
        ok = torch.ones((block_q, block_kv), dtype=torch.bool, device=dev)
        if causal:
            ok &= kp <= qp
        if flavor == "window":
            ok &= kp > qp - window
        if flavor == "chunk":
            ok &= (kp // chunk) == (qp // chunk)
        return torch.where(ok, 0.0, NEG_INF)

    if flavor == "window" and Skv == Sq and window < Skv:
        # sub-quadratic path: a fixed-width KV span per Q block
        span = min(_round_up(window + block_q, 128), Skv)
        k_pad = F.pad(k, (0, 0, 0, 0, span, 0))
        v_pad = F.pad(v, (0, 0, 0, 0, span, 0))
        outs = []
        for qi in range(nq):
            qb = q[:, qi * block_q : (qi + 1) * block_q].reshape(B, block_q, Hkv, G, hd)
            start = qi * block_q + block_q  # in padded coordinates; never past Skv
            kb = k_pad[:, start : start + span]
            vb = v_pad[:, start : start + span]
            s = _block_scores(qb, kb, scale)
            qp = (q_pos_base + qi * block_q + q_offset)[:, None]
            kp = (torch.arange(span, device=dev) + qi * block_q + block_q - span)[None, :]
            ok = (kp >= 0) & (kp <= qp) & (kp > qp - window)
            s = s + torch.where(ok, 0.0, NEG_INF)
            m = s.amax(dim=-1)
            p = torch.exp(s - m[..., None])
            l = p.sum(dim=-1)
            o = torch.einsum("bhgqk,bkhd->bhgqd", p, vb.float())
            outs.append(_finish(m, l, o, dtype))
        return _blocks_to_seq(outs, B, Sq, H, hd)

    if flavor == "chunk" and Skv == Sq and chunk < Skv:
        # block-diagonal: reshape into chunks and attend within
        if Sq % chunk:
            raise ValueError(f"sequence length {Sq} is not a multiple of the chunk {chunk}")
        nc = Sq // chunk
        out = blockwise_attention(
            q.reshape(B * nc, chunk, H, hd),
            k.reshape(B * nc, chunk, Hkv, hd),
            v.reshape(B * nc, chunk, Hkv, hd),
            causal=causal,
            flavor="full",
            q_offset=0,
            block_q=min(block_q, chunk),
            block_kv=min(block_kv, chunk),
        )
        return out.reshape(B, Sq, H, hd)

    # ---- full (or small-S window/chunk fallback): scan KV blocks ----------
    kb_all = k.reshape(B, nkv, block_kv, Hkv, hd)
    vb_all = v.reshape(B, nkv, block_kv, Hkv, hd)

    use_paired = (
        (causal_scheme == "paired" or PERF_FLAGS.get("paired_causal"))
        and flavor == "full"
        and causal
        and Sq == Skv
        and block_q == block_kv
        and q_offset == 0
        and nq == nkv
        and nq >= 2
        and nq % 2 == 0
    )
    if use_paired:
        return _paired_causal(qg, kb_all, vb_all, scale, block_q, nq, B, Hkv, G, hd, dtype)

    outs = []
    for qi in range(nq):
        qb = qg[:, qi]
        carry = (
            torch.full((B, Hkv, G, block_q), NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((B, Hkv, G, block_q), dtype=torch.float32, device=dev),
            torch.zeros((B, Hkv, G, block_q, hd), dtype=torch.float32, device=dev),
        )
        for kv_idx in range(nkv):
            s = _block_scores(qb, kb_all[:, kv_idx], scale)
            s = s + mask_for(qi * block_q, kv_idx * block_kv)
            carry = _merge_block(carry, s, vb_all[:, kv_idx])
        outs.append(_finish(*carry, dtype))
    return _blocks_to_seq(outs, B, Sq, H, hd)


def _paired_causal(qg, kb_all, vb_all, scale, blk, nq, B, Hkv, G, hd, dtype):
    """Triangular pair schedule: Q block p pairs with Q block nq-1-p; the
    pair's causal KV work is a constant nq+1 blocks (steps t <= p serve
    block p from KV block t, the rest serve block nq-1-p from KV block
    t-p-1), so the schedule covers exactly the lower triangle."""
    dev = qg.device
    ar = torch.arange(blk, device=dev)

    def zero():
        return (
            torch.full((B, Hkv, G, blk), NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((B, Hkv, G, blk), dtype=torch.float32, device=dev),
            torch.zeros((B, Hkv, G, blk, hd), dtype=torch.float32, device=dev),
        )

    outs_a, outs_b = [], []
    for p in range(nq // 2):
        a_idx, b_idx = p, nq - 1 - p
        ca, cb = zero(), zero()
        for t in range(nq + 1):
            is_a = t <= p
            kv_idx = t if is_a else t - p - 1
            s = _block_scores(qg[:, a_idx if is_a else b_idx], kb_all[:, kv_idx], scale)
            qpos = (ar + (a_idx if is_a else b_idx) * blk)[:, None]
            kpos = (ar + kv_idx * blk)[None, :]
            s = s + torch.where(kpos <= qpos, 0.0, NEG_INF)
            if is_a:
                ca = _merge_block(ca, s, vb_all[:, kv_idx])
            else:
                cb = _merge_block(cb, s, vb_all[:, kv_idx])
        outs_a.append(_finish(*ca, dtype))
        outs_b.append(_finish(*cb, dtype))
    # block order: p from the front, nq-1-p from the back
    return _blocks_to_seq(outs_a + outs_b[::-1], B, nq * blk, Hkv * G, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, valid_len):
    """Single-token decode: q (B, 1, H, hd) over k/v caches (B, S, Hkv, hd)
    of which the first ``valid_len`` positions are live (an int or a
    per-batch (B,) array); returns (B, 1, H, hd) in q's dtype."""
    B, S, Hkv, hd = k_cache.shape
    H = q.shape[2]
    G = H // Hkv
    qg = q.reshape(B, 1, Hkv, G, hd)
    s = _block_scores(qg, k_cache, 1.0 / math.sqrt(hd))  # (B,Hkv,G,1,S)
    pos = torch.arange(S, device=s.device)[None, None, None, None, :]
    if not isinstance(valid_len, int):  # an int needs no host-to-device copy
        valid_len = torch.as_tensor(valid_len, device=s.device).reshape(-1, 1, 1, 1, 1)
    s = torch.where(pos < valid_len, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v_cache.float())
    out = _finish(m, l, o, q.dtype)  # (B,Hkv,G,1,hd)
    return out.movedim(-2, 1).reshape(B, 1, H, hd)


# ---------------------------------------------------------------------------
# MLP + loss
# ---------------------------------------------------------------------------


def swiglu(x, w_gate, w_up, w_down):
    g = torch.einsum("bsd,df->bsf", x, w_gate)
    u = torch.einsum("bsd,df->bsf", x, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.einsum("bsf,fd->bsd", h, w_down)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None, total=None) -> torch.Tensor:
    """Token-mean CE in f32: ``logsumexp - gold`` per token. logits (B,S,V),
    labels (B,S) int; ``mask`` (B,S) weights the tokens (the mean over its
    sum, at least 1).  ``total`` (a 0-d f32 tensor) replaces the count: the
    (weighted) sum over it, one rounding, as a data-parallel rank divides
    its share of a global mean."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return mean(nll) if total is None else nll.sum() / total
    mask = mask.float()
    return (nll * mask).sum() / (torch.clamp(mask.sum(), min=1.0) if total is None else total)
