"""64-bit key handling for the PyTorch port of DPA-Store.

Keys live on the device as two u32 limbs ``(hi, lo)`` in the last axis, the
layout of the JAX package.  Torch has no u32 arithmetic on the CPU, so every
u32 tensor here is an ``int32`` tensor holding the same bit pattern: pools
and requests keep the reference's bytes exactly, and the CUDA kernels
reinterpret them as ``uint32_t``.  The plain torch functions widen to int64
(``& 0xFFFFFFFF``) before they compare, subtract, shift or take ``%``, and
u32 multiplies keep only the low 32 bits.

Model evaluation subtracts the segment anchor exactly in limb arithmetic and
only then converts the delta to f32 — the error bound in the JAX package's
``core/keys.py`` carries over unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

U32_MASK = np.uint64(0xFFFFFFFF)
KEY_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
_M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# host (numpy, u64) <-> device (u32 limbs held in int32) conversion
# ---------------------------------------------------------------------------


def split_u64(keys: np.ndarray) -> np.ndarray:
    """u64 array (...,) -> u32 limb array (..., 2) with [..., 0]=hi, [..., 1]=lo."""
    keys = np.asarray(keys, dtype=np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & U32_MASK).astype(np.uint32)
    return np.stack([hi, lo], axis=-1)


def join_u64(limbs: np.ndarray) -> np.ndarray:
    """u32 limb array (..., 2) -> u64 array (...,).  Accepts int32-held limbs."""
    limbs = np.asarray(limbs)
    if limbs.dtype == np.int32:
        limbs = limbs.view(np.uint32)
    hi = limbs[..., 0].astype(np.uint64)
    lo = limbs[..., 1].astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def limbs_to_tensor(limbs: np.ndarray, device) -> torch.Tensor:
    """u32 numpy limbs -> int32 tensor with the same bit patterns."""
    arr = np.ascontiguousarray(np.asarray(limbs, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(arr).to(device)


def u32(x: torch.Tensor) -> torch.Tensor:
    """Widen an int32-held u32 tensor to its unsigned value in int64."""
    return x.to(torch.int64) & _M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 value in [0, 2^32) -> int32 holding the same u32 bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


# ---------------------------------------------------------------------------
# limb ops on widened (int64, unsigned-valued) tensors
# ---------------------------------------------------------------------------


def limb_le(a_hi, a_lo, b_hi, b_lo):
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo <= b_lo))


def limb_eq(a_hi, a_lo, b_hi, b_lo):
    return (a_hi == b_hi) & (a_lo == b_lo)


def limb_sub_to_f32(a_hi, a_lo, b_hi, b_lo):
    """Exact u64 ``a - b`` (caller guarantees ``a >= b``) converted to f32.

    Borrow-propagated limb subtraction, then ``hi * 2^32 + lo`` in f32: the
    conversion of each limb rounds to nearest, ``hi * 2^32`` is exact (a
    power-of-two scale), and the add rounds once — the reference's order.
    """
    borrow = (a_lo < b_lo).to(torch.int64)
    lo = (a_lo - b_lo) & _M32
    hi = (a_hi - b_hi - borrow) & _M32
    return hi.to(torch.float32) * 4294967296.0 + lo.to(torch.float32)


def floor_to_i32_saturating(pred: torch.Tensor) -> torch.Tensor:
    """``floor(pred)`` as int32 with the reference's saturating conversion
    (values >= 2^31 become 2^31 - 1, NaN becomes 0), returned in int64.

    A plain ``.to(torch.int32)`` wraps out-of-range values on the CPU; far
    queries on sparse data predict ranks far beyond 2^31, so the saturation
    is spelled out: floor, clamp to [-2^31, 2^31] in f32 (both exact), widen,
    clamp to the int32 range."""
    f = torch.floor(pred)
    f = torch.where(torch.isnan(f), torch.zeros_like(f), f)
    f = torch.clamp(f, -2147483648.0, 2147483648.0).to(torch.int64)
    return torch.clamp(f, -(2**31), 2**31 - 1)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``a * c`` for ``a`` in [0, 2^32): split so that no
    partial product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def limb_hash(hi, lo, salt: int = 0):
    """32-bit mix hash of a 64-bit key (bit-identical to the reference's
    u32 ``limb_hash``).  Takes and returns widened int64 values."""
    h = hi ^ _mul32(lo, 0x9E3779B9) ^ ((salt * 0x85EBCA6B + 0xC2B2AE35) & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h


def limb_hash_np(keys_u64: np.ndarray, salt: int = 0) -> np.ndarray:
    """Numpy mirror of :func:`limb_hash` (must stay bit-identical)."""
    keys_u64 = np.asarray(keys_u64, dtype=np.uint64)
    hi = (keys_u64 >> np.uint64(32)).astype(np.uint32)
    lo = (keys_u64 & U32_MASK).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = hi ^ (lo * np.uint32(0x9E3779B9)) ^ np.uint32(
            (salt * 0x85EBCA6B + 0xC2B2AE35) & 0xFFFFFFFF
        )
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x7FEB352D)
        h = h ^ (h >> np.uint32(15))
        h = h * np.uint32(0x846CA68B)
        h = h ^ (h >> np.uint32(16))
    return h


# ---------------------------------------------------------------------------
# tenant namespaces: a tenant id in the top bits of the u64 key
# ---------------------------------------------------------------------------
#
# The prefix rides the most significant bits, so every tenant owns one
# contiguous slab [tenant_floor, tenant_ceil) of the global ordered key
# space: GET/PUT/DELETE route unchanged and a RANGE stays one ordered scan
# clipped at the tenant's ceiling.  For bits <= 32 the prefix lives wholly
# in the hi limb: encode is ``hi' = (tid << (32 - bits)) | hi``, lo untouched.

TENANT_BITS = 8  # default namespace width: up to 256 tenants


def _check_bits(bits: int) -> int:
    if not (1 <= int(bits) <= 32):
        raise ValueError(f"tenant prefix must use 1..32 bits, got {bits}")
    return int(bits)


def tenant_capacity(bits: int = TENANT_BITS) -> int:
    """Number of tenant namespaces a ``bits``-wide prefix can hold."""
    return 1 << _check_bits(bits)


def tenant_span_bits(bits: int = TENANT_BITS) -> int:
    """Width of each tenant's local key space (64 - prefix bits)."""
    return 64 - _check_bits(bits)


def encode_tenant(tid: int, keys, bits: int = TENANT_BITS) -> np.ndarray:
    """Pack tenant ``tid`` into the top ``bits`` of local u64 ``keys``.
    Raises ``ValueError`` when ``tid`` does not fit the prefix or a local
    key does not fit the remaining ``64 - bits`` (a silent wrap would leak
    it into a neighbour's slab)."""
    bits = _check_bits(bits)
    if not (0 <= int(tid) < (1 << bits)):
        raise ValueError(f"tenant id {tid} out of range for {bits}-bit prefix (capacity {1 << bits})")
    keys = np.atleast_1d(np.asarray(keys, dtype=np.uint64))
    limbs = split_u64(keys)
    hi = limbs[..., 0]
    if np.any(hi >> np.uint32(32 - bits)):
        raise ValueError(f"local key(s) exceed the {64 - bits}-bit tenant namespace")
    limbs[..., 0] = hi | np.uint32(int(tid) << (32 - bits))
    return join_u64(limbs)


def decode_tenant(keys, bits: int = TENANT_BITS):
    """Inverse of :func:`encode_tenant`: ``(tenant ids, local keys)``."""
    bits = _check_bits(bits)
    keys = np.atleast_1d(np.asarray(keys, dtype=np.uint64))
    limbs = split_u64(keys)
    hi = limbs[..., 0]
    tids = (hi >> np.uint32(32 - bits)).astype(np.int64)
    limbs[..., 0] = hi & np.uint32((1 << (32 - bits)) - 1)
    return tids, join_u64(limbs)


def tenant_floor(tid: int, bits: int = TENANT_BITS) -> np.uint64:
    """Inclusive floor of tenant ``tid``'s slab of the global key space."""
    return encode_tenant(tid, np.uint64(0), bits)[0]


def tenant_ceil(tid: int, bits: int = TENANT_BITS) -> np.uint64:
    """Exclusive ceiling of tenant ``tid``'s slab: the ``k_max`` a RANGE
    clips at.  The last tenant's true ceiling, 2^64, does not fit, so
    ``KEY_MAX`` stands in; it excludes only the reserved sentinel."""
    bits = _check_bits(bits)
    if not (0 <= int(tid) < (1 << bits)):
        raise ValueError(f"tenant id {tid} out of range for {bits}-bit prefix")
    if int(tid) == (1 << bits) - 1:
        return KEY_MAX
    return tenant_floor(int(tid) + 1, bits)


def tenant_of_np(keys, bits: int = TENANT_BITS) -> np.ndarray:
    """Tenant id of each encoded u64 key (host mirror of ``limb_tenant``)."""
    return decode_tenant(keys, bits)[0]


def limb_tenant(hi: torch.Tensor, bits: int = TENANT_BITS) -> torch.Tensor:
    """Tenant id (int32) of int32-held hi limbs.  The limb is widened first:
    a shift of the int32 itself would be arithmetic and turn every id at or
    above 2^(bits-1) negative."""
    return (u32(hi) >> (32 - _check_bits(bits))).to(torch.int32)
