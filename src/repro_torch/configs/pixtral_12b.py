"""pixtral-12b [vlm]: 40L d_model=5120 32H (kv=8) d_ff=14336 vocab=131072.
Mistral-Nemo text backbone; the pixtral-ViT frontend is a STUB (input_specs
provides patch embeddings).  Full attention -> long_500k skipped.
[hf:mistralai/Pixtral-12B-2409]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    frontend="vision",
    rope_theta=1e9,
)
