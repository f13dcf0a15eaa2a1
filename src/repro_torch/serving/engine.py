"""Serving engine — so far only ``PagedAttentionLayer`` of the JAX package's
``serving/engine.py``: one attention layer served through the learned-index
paged KV cache.  The rest of that module (``Engine``, the dense-cache batched
prefill and decode, and the ``KVWaveDriver`` scheduler) is still to port.
"""

from __future__ import annotations

import torch

from ..models.layers import decode_attention
from .paged_cache import PagedCache


class PagedAttentionLayer:
    """One attention layer served through the learned-index paged cache.

    Equivalent dense computation is ``decode_attention(q, K, V)``; the tests
    and ``chip_smoke.py`` hold the paged path against it."""

    def __init__(self, kv_heads: int, head_dim: int, block_size: int = 16, n_blocks: int = 512, device=None):
        self.cache = PagedCache(n_blocks, block_size, kv_heads, head_dim, device=device)
        self.kv_heads = kv_heads
        self.head_dim = head_dim

    def append(self, seq_id: int, k, v) -> None:
        self.cache.append(seq_id, k, v)

    def attend(self, seq_id: int, q: torch.Tensor) -> torch.Tensor:
        """q (H, hd) for the newest position -> (H, hd) output."""
        k, v, n = self.cache.gather(seq_id)
        q = torch.as_tensor(q, device=k.device)
        out = decode_attention(q[None, None], k[None], v[None], n)
        return out[0, 0]
