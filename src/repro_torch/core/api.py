"""Canonical ``KVStore`` API: one signature set for every store implementation.

The paper's protocol is one wire format regardless of how many DPAs serve
it, but this repo's surfaces had drifted: ``DPAStore`` and
``ShardedDPAStore`` disagreed on parameter names (``keys_u64`` vs plain
``keys``), on which kwargs exist (``auto_retry`` was single-store only,
``epoch``/``k_max`` were sharded-only), and on whether tuning knobs were
positional.  This module pins the contract both implement identically:

    get(keys, *, epoch=None, as_of=None)      -> (vals u64, found bool)
    put(keys, vals, *, auto_retry=True, ttl=None) -> status i32 per key
    delete(keys, *, auto_retry=True)          -> status i32 per key
    range(k_min, limit, *, k_max=None, epoch=None, as_of=None) -> RangeResult

plus the shared tuning kwargs (``max_leaves``; the sharded tier also takes
``fanout``) which stay keyword arguments with identical defaults.  ``epoch``
selects the ownership epoch a request wave was admitted under (rebalance
handoffs and primary failovers keep two epochs live — see
``distributed.rebalance.OwnershipTable``); implementations without routing
epochs accept only ``None``.  ``as_of`` selects a *version* epoch — a
point-in-time read against the snapshot named by ``snapshot_epoch()``,
served from the bounded multi-version window kept when the store was built
with ``retain_epochs > 0``; reads past the retained horizon raise
:class:`~repro_torch.core.epoch.EpochRetiredError` (re-exported here).  ``ttl``
stamps written keys with a logical-clock deadline (see
``repro_torch.core.ttl.TTLTracker``): expired keys read as absent and are
physically reclaimed by the ``ttl_sweep()`` compaction pass.  Divergent
legacy spellings keep working through :func:`warn_legacy` shims that emit
``DeprecationWarning``.

:class:`RangeResult` replaces the ad-hoc tuple returns of ``range`` /
``range_with_state``: named fields for new code, tuple-unpacking at the
legacy arity (3 for ``range``, 6 for ``range_with_state``) for old code.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from .epoch import EpochRetiredError  # noqa: F401  (canonical re-export)


def warn_legacy(method: str, old: str, new: str) -> None:
    """Emit the deprecation for a legacy call spelling.  ``stacklevel=3``
    points the warning at the caller of the store method, not the shim."""
    warnings.warn(
        f"{method}: {old} is deprecated; use {new} "
        f"(canonical KVStore signature, see repro_torch.core.api)",
        DeprecationWarning,
        stacklevel=3,
    )


def take_legacy(method: str, legacy: Dict[str, Any], value, canonical: str, *old_names: str):
    """Resolve a parameter that may arrive under a legacy keyword name:
    returns ``value`` unless one of ``old_names`` is present in ``legacy``
    (popped + deprecation-warned).  Any name left in ``legacy`` after every
    parameter has been resolved is a genuine TypeError for the caller."""
    for old in old_names:
        if old in legacy:
            if value is not None:
                raise TypeError(f"{method}: got both {canonical!r} and legacy {old!r}")
            warn_legacy(method, f"keyword {old!r}", f"{canonical!r}")
            value = legacy.pop(old)
    return value


def reject_unknown(method: str, legacy: Dict[str, Any]) -> None:
    if legacy:
        raise TypeError(f"{method}: unexpected keyword arguments {sorted(legacy)}")


@dataclass(frozen=True)
class RangeResult:
    """RANGE response: ascending live entries per request row.

    Named fields for new code; iteration/indexing reproduce the legacy
    tuple shape (``_arity`` = 3 from ``range``, 6 from ``range_with_state``)
    so existing ``rk, rv, rc = store.range(...)`` unpacking, ``zip`` loops
    and ``result[2]`` indexing keep working bitwise-unchanged.
    """

    keys: np.ndarray  # (n, limit) u64, zeros past ``counts``
    vals: np.ndarray  # (n, limit) u64
    counts: np.ndarray  # (n,) results found per row
    truncated: Optional[np.ndarray] = None  # (n,) bool — bounded walk cut
    cursor_leaf: Optional[np.ndarray] = None  # (n,) i32 resume leaf (-1 = fresh)
    cursor_key: Optional[np.ndarray] = None  # (n,) u64 last emitted key
    rounds: int = 0  # device continuation rounds the dispatch(es) ran
    stats: Dict[str, int] = field(default_factory=dict)
    _arity: int = 3  # legacy tuple length for iter/len/index back-compat

    # -- legacy aliases (older field spellings) ---------------------------
    @property
    def values(self) -> np.ndarray:
        return self.vals

    @property
    def found(self) -> np.ndarray:
        return self.counts

    # -- tuple back-compat ------------------------------------------------
    def _legacy_tuple(self) -> Tuple:
        full = (
            self.keys,
            self.vals,
            self.counts,
            self.truncated,
            self.cursor_leaf,
            self.cursor_key,
        )
        return full[: self._arity]

    def __iter__(self):
        return iter(self._legacy_tuple())

    def __len__(self) -> int:
        return self._arity

    def __getitem__(self, i):
        return self._legacy_tuple()[i]


@runtime_checkable
class KVStore(Protocol):
    """The canonical store protocol — ``DPAStore`` and ``ShardedDPAStore``
    implement exactly these signatures (plus tuning kwargs with identical
    defaults); ``tests/test_api_protocol.py`` asserts conformance from one
    table of cases across single-store, hash, range and replicated tiers."""

    def get(
        self,
        keys,
        *,
        epoch: Optional[int] = None,
        as_of: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched point lookup: (vals u64, found bool), row-aligned with
        ``keys``.  ``epoch`` routes by the ownership epoch the wave was
        admitted under (implementations without routing epochs accept only
        ``None``).  ``as_of`` pins the read to a retained version epoch
        (:class:`EpochRetiredError` outside the window)."""
        ...

    def put(
        self,
        keys,
        vals,
        *,
        auto_retry: bool = True,
        ttl: Optional[int] = None,
    ) -> np.ndarray:
        """INSERT/UPDATE: i32 status per key (0 = OK = acknowledged durable
        on every in-sync replica; 1 = RETRY when ``auto_retry=False`` and
        the insert buffer was full).  ``ttl=K`` expires the keys after K
        logical clock ticks."""
        ...

    def delete(self, keys, *, auto_retry: bool = True) -> np.ndarray:
        """DELETE: i32 status per key (same contract as :meth:`put`)."""
        ...

    def range(
        self,
        k_min,
        limit: int = 10,
        *,
        k_max=None,
        epoch: Optional[int] = None,
        as_of: Optional[int] = None,
    ) -> RangeResult:
        """RANGE(k_min, limit) per request row: ascending live entries,
        clipped to ``[k_min, k_max)`` when ``k_max`` is given (scalar or
        per-row, exclusive).  ``as_of`` walks the retained snapshot at that
        version epoch instead of the live tree."""
        ...

    def flush(self) -> int:
        """Drain staged writes through the patch/stitch pipeline."""
        ...

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        """All live pairs in global key order."""
        ...
