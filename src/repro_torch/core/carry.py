"""Carry device state between the JAX package and the port.

The JAX package keeps its device state in NamedTuples of jnp arrays;
``{f: np.asarray(getattr(state, f)) for f in state._fields}`` turns one into
a dict of numpy arrays.  The ``*_from_numpy`` functions take such a dict and
return the port's state on a given device; the ``*_to_numpy`` inverses give
back the same dict (u32 arrays as ``uint32``, flags as ``bool``).  This is
the counterpart of carrying weights: it lets one test feed the same tree,
insert buffers and caches to both packages.

A whole paged KV cache is carried by ``serving.paged_cache.PagedCache``'s
``from_numpy`` / ``to_numpy``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .hotcache import CacheState
from .lookup import InsertBuffers
from .scancache import ScanCacheState
from .tree import DeviceTree


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def _to_numpy(t: torch.Tensor, u32: bool) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if u32 else a


def _from(cls, d: Dict[str, np.ndarray], device):
    return cls(**{f: _to_tensor(d[f], device) for f in cls._fields if f in d})


def _to(state, u32_fields) -> Dict[str, np.ndarray]:
    return {
        f: _to_numpy(getattr(state, f), f in u32_fields)
        for f in state._fields
        if isinstance(getattr(state, f), torch.Tensor)
    }


_TREE_U32 = {"node_seg_first", "pivot_keys", "leaf_anchor", "hbm_keys", "hbm_vals"}
_IB_U32 = {"keys", "vals"}
_CACHE_U32 = {"bloom", "bkey", "bval"}
_SCAN_U32 = {"bloom", "bkey"}


def tree_from_numpy(d: Dict[str, np.ndarray], device) -> DeviceTree:
    return _from(DeviceTree, d, device)


def tree_to_numpy(tree: DeviceTree) -> Dict[str, np.ndarray]:
    return _to(tree, _TREE_U32)


def ib_from_numpy(d: Dict[str, np.ndarray], device) -> InsertBuffers:
    return _from(InsertBuffers, d, device)


def ib_to_numpy(ib: InsertBuffers) -> Dict[str, np.ndarray]:
    return _to(ib, _IB_U32)


def cache_from_numpy(d: Dict[str, np.ndarray], device) -> CacheState:
    return _from(CacheState, d, device)


def cache_to_numpy(cache: CacheState) -> Dict[str, np.ndarray]:
    return _to(cache, _CACHE_U32)


def scan_cache_from_numpy(d: Dict[str, np.ndarray], device) -> ScanCacheState:
    return _from(ScanCacheState, d, device)


def scan_cache_to_numpy(cache: ScanCacheState) -> Dict[str, np.ndarray]:
    return _to(cache, _SCAN_U32)
