"""Serving layer of the port: the wave pipeline (``pipeline``), per-tenant
admission (``admission``), the multi-tenant wave scheduler
(``engine.KVWaveDriver``), the paged KV cache (``paged_cache``) and the
attention layer served through it (``engine.PagedAttentionLayer``)."""
