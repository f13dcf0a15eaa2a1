"""llama4-scout-17b-16e [moe]: 48L d_model=5120 40H (kv=8) d_ff=8192
vocab=202048, 16 experts top-1 + shared expert; iRoPE chunked local attention
(8k chunks) with full attention every 4th layer -> sub-quadratic, long_500k
runs.  [hf:meta-llama/Llama-4-Scout-17B-16E]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    experts_per_token=1,
    shared_expert=True,
    chunk=8192,
    full_attn_every=4,
)
