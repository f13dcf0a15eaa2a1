"""Checkpoints of the port: ``manager`` (atomic, mesh-independent, async),
on-disk compatible with the JAX package's ``checkpoint/manager.py``."""
