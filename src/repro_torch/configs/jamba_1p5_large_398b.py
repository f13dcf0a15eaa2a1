"""jamba-1.5-large [hybrid]: 72L d_model=8192 64H (kv=8) d_ff=24576
vocab=65536, Mamba+attention 1:7 interleave, MoE 16e top-2 every other
layer -> long_500k runs (SSM + 9 attention layers with context-parallel
cache).  Adafactor states at 398B.  [arXiv:2403.19887]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    ssm_state=128,
    ssm_head_dim=64,
    attn_every=8,
    optimizer="adafactor",
)
