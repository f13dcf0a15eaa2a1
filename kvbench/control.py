"""The control: the plain reference put in the program's place with one
guarantee of the configuration broken, driven by the same client loop and
judged by the same comparison, which has to find it wrong.

* ``value32``: values keep only their low 32 bits (the configuration states
  8-byte values; half the value bytes is the tempting cut).
* ``stale``: a write is acknowledged at once but becomes visible only when
  the next write wave arrives (the configuration states that every
  acknowledged write is read back by later reads).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from .reference import SortedMap

FAULTS = ("value32", "stale")
LOW32 = np.uint64(0xFFFFFFFF)


class _Done:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class ControlStore:
    """The pipeline's surface (``submit_*`` and ``result``) over a
    :class:`~kvbench.reference.SortedMap`."""

    def __init__(self, keys, vals, fault: str):
        if fault not in FAULTS:
            raise ValueError(f"control fault {fault!r}: one of {FAULTS}")
        self.map = SortedMap(keys, vals)
        self.fault = fault
        self._lagged = None

    def _vals(self, v):
        return v & LOW32 if self.fault == "value32" else v

    def submit_get(self, keys):
        v, f = self.map.get(keys)
        return _Done((self._vals(v), f))

    def submit_range(self, starts, limit, *, max_leaves: int = 4):
        k, v, c = self.map.scan(starts, limit)
        return _Done(SimpleNamespace(keys=k, vals=self._vals(v), counts=c))

    def submit_put(self, keys, vals):
        keys = np.array(keys, dtype=np.uint64)
        vals = np.array(vals, dtype=np.uint64)
        if self.fault == "stale":
            if self._lagged is not None:
                self.map.put(*self._lagged)
            self._lagged = (keys, vals)
        else:
            self.map.put(keys, vals)
        return _Done(np.zeros(keys.size, dtype=np.int32))

    def result(self, ticket):
        return ticket.value


class ControlProgram:
    """What the harness drives in place of the program under test."""

    def __init__(self, keys, vals, fault: str):
        self.pipe = ControlStore(keys, vals, fault)

    def counters(self):
        return {}

    def shard_drain_ns(self):
        return None

    def ledger_records(self):
        return []

    def close(self) -> None:
        self.pipe = None
