"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (kv=8) d_ff=10240
vocab=32000, llama+mistral mix with sliding-window attention -> long_500k
runs.  [arXiv:2401.16818]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    window=4096,
    head_dim=120,
)
