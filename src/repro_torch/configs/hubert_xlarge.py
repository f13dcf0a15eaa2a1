"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.
Encoder-only (same arch as wav2vec2); the conv waveform frontend is a STUB —
input_specs provides precomputed frame embeddings.  [arXiv:2106.07447]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    frontend="audio",
    rope_theta=10_000.0,
)
