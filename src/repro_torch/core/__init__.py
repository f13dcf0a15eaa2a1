"""DPA-Store core, ported to PyTorch: keys (u64 as int32-held u32 limbs),
pla and tree (host image + device pools), lookup (batched traversal), the
insert buffers and the two caches, patch + stitch + epoch (the update
cycle and the point-in-time window), ttl (expiry deadlines), carry (state
exchange with the JAX package) and the store facade.
"""

from .tree import TreeConfig, TreeImage, DeviceTree, build_image, SEG_CAP, NODE_SEGS
from .api import KVStore, RangeResult
from .epoch import EpochRetiredError
from .hotcache import CacheConfig
from .scancache import ScanCacheConfig
from .store import DPAStore, StoreStats, STATUS_OK, STATUS_RETRY
from .ttl import TTLTracker

__all__ = [
    "KVStore",
    "RangeResult",
    "TreeConfig",
    "TreeImage",
    "DeviceTree",
    "build_image",
    "SEG_CAP",
    "NODE_SEGS",
    "CacheConfig",
    "ScanCacheConfig",
    "DPAStore",
    "StoreStats",
    "STATUS_OK",
    "STATUS_RETRY",
    "EpochRetiredError",
    "TTLTracker",
]
