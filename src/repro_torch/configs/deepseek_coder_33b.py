"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (kv=8) d_ff=19200
vocab=32256, llama-arch full attention -> long_500k skipped (DESIGN.md).
[arXiv:2401.14196]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100_000.0,
)
