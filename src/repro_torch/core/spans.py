"""Named host spans: one table of time and calls per name, and the
``torch.profiler`` label of the same span while a profiler records.

``with span(table, "kv/get/launch"):`` adds the nanoseconds between entry
and exit (``time.perf_counter_ns``) and one call to ``table["kv/get/launch"]``.
While a profiler records (``torch.autograd.profiler._is_profiler_enabled``,
a module global the profiler sets), the span also enters
``torch.profiler.record_function(name)``, so it lands on the profiler's
timeline beside the device events it launched; with no profiler it is two
clock reads and a dict update.  Spans go at wave, phase or flush-cycle
granularity, never per key or per row.  A site that runs tens of times a
wave (a flush cycle) may, while no profiler records, read ``clock()`` itself
and add to its ``entry``, which costs no ``with`` block.

Totals nest: a span's time includes the spans inside it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterable, List, Tuple

import torch
from torch.autograd import profiler as _profiler

clock = time.perf_counter_ns

_NO_LABEL = contextlib.nullcontext()


def label(name: str):
    """The profiler label ``name`` while a profiler records, else nothing."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_LABEL


def recording() -> bool:
    """Whether a profiler records now."""
    return _profiler._is_profiler_enabled


class SpanTable(dict):
    """``name -> [ns, calls]``."""

    def entry(self, name: str) -> List[int]:
        """``name``'s ``[ns, calls]``, made empty if new: a hot site adds to
        it in place."""
        e = self.get(name)
        if e is None:
            e = self[name] = [0, 0]
        return e

    def add(self, name: str, ns: int, calls: int = 1) -> None:
        e = self.entry(name)
        e[0] += ns
        e[1] += calls

    def totals(self) -> Dict[str, Tuple[int, int]]:
        """A copy of the spans called so far: ``name -> (ns, calls)``."""
        return {k: (v[0], v[1]) for k, v in self.items() if v[1]}


def sum_totals(tables: Iterable[Dict[str, Tuple[int, int]]]) -> Dict[str, Tuple[int, int]]:
    """``totals()`` of several tables added name by name."""
    out = SpanTable()
    for t in tables:
        for k, (ns, calls) in t.items():
            out.add(k, ns, calls)
    return out.totals()


def format_totals(totals: Dict[str, Tuple[int, int]]) -> str:
    """``name ms/calls`` for each span, the longest first."""
    rows = sorted(totals.items(), key=lambda kv: -kv[1][0])
    return ", ".join(f"{k} {ns / 1e6:.1f}ms/{calls}" for k, (ns, calls) in rows)


class span:
    """Time one phase into ``table`` under ``name``."""

    __slots__ = ("table", "name", "_rf", "_t0")

    def __init__(self, table: SpanTable, name: str):
        self.table = table
        self.name = name

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self._t0 = clock()
        return self

    def __exit__(self, *exc):
        ns = clock() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        e = self.table.get(self.name)
        if e is None:
            self.table[self.name] = [ns, 1]
        else:
            e[0] += ns
            e[1] += 1
        return False
