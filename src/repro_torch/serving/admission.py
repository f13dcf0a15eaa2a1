"""Per-tenant admission control for the wave scheduler (a copy of the JAX
package's ``serving/admission.py``, which is pure Python).

The paper's ingestion loop (and *Demystifying DPA-enhanced SmartNICs*,
PAPERS.md) shows the accelerator's throughput collapsing when the host
pushes unbounded request batches at the steering threads: admission at the
ingestion boundary is what keeps the wave pipeline at its roofline instead
of queueing without bound.  This module is that boundary for the
multi-tenant front end (:class:`repro_torch.serving.engine.KVWaveDriver`):

* **Token-bucket rate limits** — each tenant's bucket refills at
  ``rate`` ops per *logical tick* (``KVWaveDriver``'s logical clock, advanced by
  ``KVWaveDriver.tick``) up to ``burst``.  A request is admitted only if
  the bucket holds tokens for every key it carries; otherwise the whole
  request is refused with an explicit RETRY — tokens are only deducted on
  admission, so a refusal is side-effect-free and re-submission after a
  refill is lossless (never a silent drop, mirroring the insert-buffer
  RETRY status the store already uses for back-pressure).
* **Weighted QoS shares** — ``weight`` feeds ``KVWaveDriver``'s wave-packing
  loop: when a sealing wave cannot hold every forming queue, tenants get
  rows in proportion to their weights (deficit-style weighted round
  robin), so one tenant's burst cannot starve another's slots.

Admission is deliberately *request*-granular (all keys or none): a
partially-admitted batch would force the client to diff statuses to learn
which keys to re-send, while the all-or-nothing RETRY keeps the re-submit
path identical to the store's own back-pressure contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


#: request-level admission outcomes (string statuses ride ``KVWaveDriver``'s
#: replies; the store's own i32 statuses are per-key and unrelated)
ADMIT_OK = "ok"
ADMIT_RETRY = "retry"


@dataclass
class TenantPolicy:
    """Admission policy for one tenant.

    ``rate``  — ops (keys) admitted per logical tick; ``0`` = unlimited.
    ``burst`` — bucket capacity in ops (defaults to 4x rate; the bucket
                starts full so a fresh tenant can burst immediately).
    ``weight``— fair-share weight for wave packing (relative, > 0).
    """

    rate: float = 0.0
    burst: Optional[float] = None
    weight: float = 1.0

    def __post_init__(self):
        if self.rate < 0:
            raise ValueError(f"rate must be >= 0, got {self.rate}")
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.burst is None:
            self.burst = 4.0 * self.rate if self.rate > 0 else 0.0
        if self.rate > 0 and self.burst <= 0:
            raise ValueError(f"burst must be > 0 with a rate, got {self.burst}")


@dataclass
class _Bucket:
    rate: float
    burst: float
    level: float
    last: int  # logical tick of the last refill

    def _refill(self, now: int) -> None:
        if now > self.last:
            self.level = min(self.burst, self.level + self.rate * (now - self.last))
            self.last = now

    def try_take(self, n: int, now: int) -> bool:
        """Deduct ``n`` tokens iff available — refusal leaves the bucket
        untouched (the lossless-RETRY half of the admission contract)."""
        self._refill(now)
        if self.level >= n:
            self.level -= n
            return True
        return False


@dataclass
class TenantCounters:
    admitted_requests: int = 0
    admitted_keys: int = 0
    retried_requests: int = 0
    retried_keys: int = 0


class AdmissionController:
    """Per-tenant token buckets + QoS weights over a logical clock.

    ``policies`` maps tenant id -> :class:`TenantPolicy`; tenants without
    an entry fall back to ``default`` (unlimited, weight 1.0 unless one is
    given).  ``admit(tenant, n, now)`` is the single decision point the
    wave scheduler calls at ``request()`` time."""

    def __init__(
        self,
        policies: Optional[Dict[int, TenantPolicy]] = None,
        default: Optional[TenantPolicy] = None,
    ):
        self.policies: Dict[int, TenantPolicy] = dict(policies or {})
        self.default = default if default is not None else TenantPolicy()
        self._buckets: Dict[int, _Bucket] = {}
        self.counters: Dict[int, TenantCounters] = {}

    def policy(self, tenant) -> TenantPolicy:
        return self.policies.get(tenant, self.default)

    def weight(self, tenant) -> float:
        return self.policy(tenant).weight

    def _bucket(self, tenant, now: int) -> Optional[_Bucket]:
        pol = self.policy(tenant)
        if pol.rate <= 0:  # unlimited
            return None
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = _Bucket(
                rate=pol.rate, burst=pol.burst, level=pol.burst, last=now
            )
        return b

    def admit(self, tenant, n: int, now: int) -> bool:
        """All-or-nothing admission of an ``n``-key request at logical time
        ``now``.  A refusal consumes no tokens — re-submitting the same
        request after the bucket refills is lossless by construction."""
        c = self.counters.setdefault(tenant, TenantCounters())
        b = self._bucket(tenant, now)
        ok = True if b is None else b.try_take(n, now)
        if ok:
            c.admitted_requests += 1
            c.admitted_keys += n
        else:
            c.retried_requests += 1
            c.retried_keys += n
        return ok

    def summary(self) -> Dict:
        return {
            t: {
                "admitted_requests": c.admitted_requests,
                "admitted_keys": c.admitted_keys,
                "retried_requests": c.retried_requests,
                "retried_keys": c.retried_keys,
                "weight": self.weight(t),
                "rate": self.policy(t).rate,
            }
            for t, c in sorted(self.counters.items(), key=lambda kv: str(kv[0]))
        }
