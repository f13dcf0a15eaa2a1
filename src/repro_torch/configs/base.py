"""Architecture + shape configuration system (a copy of the JAX package's
``configs/base.py``; it imports nothing of either package).

Every assigned architecture is a frozen :class:`ArchConfig`; the four input
shapes are :class:`ShapeConfig`.  ``registry.py`` maps ``--arch`` ids to
configs; ``input_specs()`` produces ShapeDtypeStruct stand-ins so the
multi-pod dry-run never allocates.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int  # 0 => attention-free (pure SSM)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # MoE MLP cadence in layers (1 = every layer)
    shared_expert: bool = False  # llama4-style always-on shared expert
    capacity_factor: float = 1.25

    # --- attention flavour ---------------------------------------------------
    rope_theta: float = 500_000.0
    window: int = 0  # sliding-window size (0 = full attention)
    chunk: int = 0  # chunked local attention size (llama4 iRoPE)
    full_attn_every: int = 0  # every Nth layer is full attention (with chunk)
    causal: bool = True  # False => encoder-only (hubert)

    # --- SSM / hybrid --------------------------------------------------------
    ssm_state: int = 0  # mamba2 N
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0  # hybrid: one attention layer per this many (jamba 8)

    # --- misc ----------------------------------------------------------------
    frontend: str = "none"  # none | audio | vision (stubbed: embeddings in)
    norm_eps: float = 1e-5
    optimizer: str = "adamw"  # adamw | adafactor (factored states for 400B)
    remat: str = "block"  # none | block — activation checkpoint policy

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM/hybrid or windowed/chunked attention."""
        return self.has_ssm or self.window > 0 or self.chunk > 0

    @property
    def fsdp(self) -> bool:
        """Fully shard parameters over the data axis too (ZeRO-3/FSDP): at
        >=32B params the TP-only shard (1/16th) alone busts v5e HBM."""
        total, _ = self.param_counts()
        return total >= 32e9

    @property
    def superblock(self) -> int:
        """Layer-pattern period: the scan body covers this many layers so
        heterogeneous stacks (hybrid interleave, chunk/full mix, MoE cadence)
        still compile to one compact scan."""
        period = 1
        if self.attn_every:
            period = _lcm(period, self.attn_every)
        if self.full_attn_every:
            period = _lcm(period, self.full_attn_every)
        if self.n_experts and self.moe_every > 1:
            period = _lcm(period, self.moe_every)
        assert self.n_layers % period == 0, (self.name, period, self.n_layers)
        return period

    # ---- which layer gets what ------------------------------------------
    def layer_kind(self, i: int) -> str:
        """'attn' | 'mamba' for mixer at layer i (within superblock index)."""
        if not self.has_attention:
            return "mamba"
        if self.attn_every:
            # jamba: 1 attention per attn_every layers, in the middle slot
            return "attn" if (i % self.attn_every) == self.attn_every // 2 else "mamba"
        return "attn"

    def attn_flavor(self, i: int) -> str:
        """'full' | 'window' | 'chunk' for attention at layer i."""
        if self.window:
            return "window"
        if self.chunk:
            if self.full_attn_every and (i % self.full_attn_every) == (
                self.full_attn_every - 1
            ):
                return "full"
            return "chunk"
        return "full"

    def mlp_kind(self, i: int) -> str:
        """'moe' | 'dense' | 'none' for the MLP at layer i."""
        if self.d_ff == 0:
            return "none"
        if self.n_experts and (i % self.moe_every) == 0:
            return "moe"
        return "dense"

    # ---- parameter counting (for roofline MODEL_FLOPS) --------------------
    def param_counts(self) -> Tuple[int, int]:
        """(total params, active params per token)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_
        total = V * D  # embedding
        active = V * D
        out_head = V * D  # untied LM head
        total += out_head
        active += out_head
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                a = D * (self.n_heads * hd) + 2 * D * (self.n_kv_heads * hd) + (
                    self.n_heads * hd
                ) * D
                total += a
                active += a
            else:
                d_in = self.ssm_expand * D
                m = D * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim)
                m += d_in * D  # out proj
                m += self.ssm_conv * (d_in + 2 * self.ssm_state)
                total += m
                active += m
            mk = self.mlp_kind(i)
            if mk == "dense":
                m = 3 * D * F
                total += m
                active += m
            elif mk == "moe":
                m = 3 * D * F
                total += self.n_experts * m + D * self.n_experts
                active += self.experts_per_token * m
                if self.shared_expert:
                    total += m
                    active += m
            total += 2 * D  # norms
            active += 2 * D
        return total, active


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def _lcm(a: int, b: int) -> int:
    import math

    return a * b // math.gcd(a, b)


def cell_supported(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is (arch x shape) a live dry-run cell? Returns (ok, reason_if_not)."""
    if arch.is_encoder and shape.kind == "decode":
        return False, "encoder-only architecture has no autoregressive step"
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention (DESIGN.md)"
    return True, ""


def reduced(arch: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (per-arch reduced config)."""
    return replace(
        arch,
        n_layers=arch.superblock * 2,
        d_model=64,
        n_heads=max(4, 0) if arch.n_heads else 0,
        n_kv_heads=min(arch.n_kv_heads, 2) if arch.n_heads else 0,
        head_dim=16 if arch.n_heads else 0,
        d_ff=128 if arch.d_ff else 0,
        vocab_size=128,
        n_experts=min(arch.n_experts, 4),
        experts_per_token=min(arch.experts_per_token, 2),
        ssm_state=16 if arch.ssm_state else 0,
        ssm_head_dim=16 if arch.ssm_state else 64,
        window=min(arch.window, 16) if arch.window else 0,
        chunk=min(arch.chunk, 16) if arch.chunk else 0,
    )
