"""Epoch-based reclamation (Sec 3.2.3).

The paper computes a global epoch from every DPA thread's packet counters:
a node made obsolete by a stitch is freed only after every traverser has
moved past the request it was serving when the stitch landed.

Batched analogue: the store's *wave counter* is the epoch.  A wave is a
single functional update, so a wave that began before a CONNECT ran entirely
against the old tree version; once the next wave starts, no reference to the
old version can exist.  We keep the paper's safety margin of retiring ids
only after ``grace`` further epochs so that asynchronous consumers (e.g. a
client still holding a range cursor) have a bounded validity window.

Flush cycles (the batched patch/stitch pipeline) quarantine all of a cycle's
obsoleted ids in one ``defer_free_batch`` call after the cycle's CONNECT and
advance the epoch once per cycle — not once per leaf.  That is what keeps a
merged stitch batch two-phase safe: nothing freed mid-cycle can be recycled
into a COPY destination while the old tree still reaches it.

The manager is host-side bookkeeping; ``tests/test_epoch.py`` asserts the
invariant that an id is never handed back to an allocator while any epoch
that could reference it is still live.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


class EpochRetiredError(LookupError):
    """An ``as_of`` read named a version epoch outside the retained window
    (``horizon < epoch <= cycle``): the superseded leaves that served it may
    already have been released back to the allocator and reused."""


@dataclass
class EpochManager:
    grace: int = 2  # epochs an obsolete id stays quarantined
    # Versioned-read retention: keep a superseded id quarantined until at
    # least ``retain`` further stitch cycles have completed, so every leaf
    # version addressable through ``as_of=E`` (E in the retained window) is
    # still intact in the pools.  0 = no point-in-time reads (grace only).
    retain: int = 0
    epoch: int = 0
    # Completed stitch transactions — the version epoch ``as_of`` readers
    # name.  Distinct from ``epoch`` (the per-wave reclamation clock):
    # cycles advance only when a CONNECT lands, which is exactly when leaf
    # versions change.
    cycle: int = 0
    # (retire_at_epoch, pool, id, freed_cycle)
    _quarantine: List[Tuple[int, str, int, int]] = field(default_factory=list)
    # ids currently quarantined, for the safety assertion
    _held: Dict[Tuple[str, int], int] = field(default_factory=dict)
    # Quarantine listener, fired once per deferred (pool, id) — the store
    # uses it to collect leaves a stitch cycle obsoleted so the scan-anchor
    # cache can drop their anchors before the next wave probes (a leaf id
    # becomes unsafe to *start a walk at* the moment its CONNECT lands,
    # which is strictly before its grace period even begins).
    on_defer: Optional[Callable[[str, int], None]] = None

    def advance(self) -> int:
        """Called once per completed request wave."""
        self.epoch += 1
        return self.epoch

    def defer_free(self, pool: str, idx: int) -> None:
        key = (pool, int(idx))
        assert key not in self._held, f"double free of {key}"
        retire_at = self.epoch + self.grace
        # stamped with the cycle the in-flight transaction will complete as
        # (end_cycle increments ``cycle`` after the CONNECT lands)
        self._quarantine.append((retire_at, pool, int(idx), self.cycle + 1))
        self._held[key] = retire_at
        if self.on_defer is not None:
            self.on_defer(pool, int(idx))

    def defer_free_batch(self, frees) -> int:
        """Quarantine a whole flush cycle's obsoleted ids at once (called
        after the cycle's CONNECT lands).  Returns how many were deferred."""
        n = 0
        for pool, idx in frees:
            self.defer_free(pool, idx)
            n += 1
        return n

    def end_cycle(self, image) -> int:
        """Cycle-granularity bookkeeping: one epoch advance + reclaim per
        flush cycle (the per-leaf loop used to do this once per patch).
        Returns the number of ids handed back to the allocator."""
        self.cycle += 1
        self.advance()
        return self.reclaim(image)

    def reclaim(self, image) -> int:
        """Release quarantined ids whose grace period has elapsed — and, with
        retention on, whose version epoch has aged past the retained window —
        back to the host image's allocator.  Returns the number reclaimed.

        Safety for versioned walks: an id freed at cycle F serves versions
        ``as_of <= F - 1``.  It is released only once ``cycle - F >= retain``,
        i.e. when the oldest retainable epoch (``cycle - retain + 1``) already
        exceeds F - 1 — so a :meth:`check_retained`-validated walk can never
        reach a released (possibly reused) id."""

        def ready(q):
            if q[0] > self.epoch:
                return False
            # retention gate only when a point-in-time window is kept
            return self.retain <= 0 or self.cycle - q[3] >= self.retain

        out = [q for q in self._quarantine if ready(q)]
        self._quarantine = [q for q in self._quarantine if not ready(q)]
        for _, pool, idx, _ in out:
            del self._held[(pool, idx)]
            image.release(pool, idx)
        return len(out)

    # ------------------------------------------------- versioned-read window
    @property
    def horizon(self) -> int:
        """Oldest *expired* version epoch: valid ``as_of`` reads satisfy
        ``horizon < epoch <= cycle`` (empty window when ``retain == 0``)."""
        return self.cycle - self.retain

    def check_retained(self, e: int) -> int:
        """Validate an ``as_of`` epoch against the retained window, raising
        :class:`EpochRetiredError` outside it.  Returns ``e`` unchanged."""
        e = int(e)
        if self.retain <= 0:
            raise EpochRetiredError(
                f"as_of={e}: store was built with retain_epochs=0 "
                "(no point-in-time window is kept)"
            )
        if not (self.horizon < e <= self.cycle):
            raise EpochRetiredError(
                f"as_of={e}: outside the retained window "
                f"({self.horizon} < epoch <= {self.cycle})"
            )
        return e

    def is_quarantined(self, pool: str, idx: int) -> bool:
        return (pool, int(idx)) in self._held

    @property
    def pending(self) -> int:
        return len(self._quarantine)
