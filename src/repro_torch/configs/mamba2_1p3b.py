"""mamba2-1.3b [ssm]: 48L d_model=2048 attention-free, ssm_state=128 (SSD).
O(1) decode state -> long_500k natural.  [arXiv:2405.21060]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
)
