"""llama3-405b [dense]: 126L d_model=16384 128H (kv=8) d_ff=53248
vocab=128256 -> the train-scale stress cell; full attention -> long_500k
skipped.  Adafactor states (fp32 Adam m/v would not fit 256 chips).
[arXiv:2407.21783]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    optimizer="adafactor",
)
