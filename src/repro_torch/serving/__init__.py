"""Serving layer of the port; so far the paged KV cache (``paged_cache``)
and the attention layer served through it (``engine.PagedAttentionLayer``)."""
