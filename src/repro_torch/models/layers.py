"""Decode attention — the part of the JAX package's ``models/layers.py``
that the paged KV cache path runs: ``NEG_INF``, ``_block_scores``,
``_finish`` and ``decode_attention``.  The rest of that module (norms,
rotary embedding, blockwise attention, MLPs, loss) is still to port.

The score and value products are plain f32 products, as in the reference,
where they are XLA einsums outside any Pallas kernel.  ``jnp.einsum``
promotes an f32 query times a bf16 cache to f32; ``torch.einsum`` refuses
mixed types, so the operands are upcast explicitly (bf16 values are exact
in f32).  The upcast materialises an f32 copy of the cache, which the
reference avoids (``preferred_element_type``); a bf16 product with f32
accumulation is queued in ``ROADMAP.md``.  GQA never repeats KV heads: Q is grouped as (Hkv, G).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _block_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B, bq, Hkv, G, hd) x k (B, bkv, Hkv, hd) -> (B, Hkv, G, bq, bkv), f32."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale


def _finish(m, l, acc, dtype):
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(dtype)  # (B, Hkv, G, bq, hd)


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
