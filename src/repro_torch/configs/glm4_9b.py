"""glm4-9b [dense]: 40L d_model=4096 32H (kv=2) d_ff=13696 vocab=151552,
RoPE + GQA, full attention -> long_500k skipped.  [hf:THUDM/glm-4-9b]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=10_000.0,
)
