"""Model building blocks of the port; so far only what the paged KV cache
path needs (``layers.decode_attention``)."""
