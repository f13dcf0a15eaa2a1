"""Model building blocks of the port: ``layers`` (norms, rotary embedding,
blockwise and decode attention, SwiGLU), ``moe``, ``mamba``, ``lm`` (the
composable stack of the ten configs) and ``carry`` (the JAX package's
params and caches into tensors)."""
