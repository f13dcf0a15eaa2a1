"""Straggler mitigation: per-host step-time monitoring + rebalance planning
(a copy of the JAX package's ``distributed/straggler.py``).

On 1000+-node jobs the common failure shape is not a crash but a slow host
(thermal throttle, faulty HBM lane, noisy neighbour).  The watchdog keeps an
EWMA of per-host step times, flags hosts persistently slower than the fleet
median, and emits a *mitigation plan*:

  1. ``observe(host, seconds)`` each step (host-local timer, gathered via
     the regular metrics all-reduce on real deployments);
  2. a host flagged > threshold x median for ``patience`` consecutive steps
     becomes a straggler;
  3. the plan: either drop the host (elastic re-mesh via
     ``elastic.plan_remesh``) or re-slice the data pipeline so the slow host
     gets a smaller micro-shard (supported by data.pipeline.shard_batch's
     arbitrary slicing).

Pure bookkeeping — deterministic and unit-tested; the launcher wires it to
wall clocks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class StragglerConfig:
    ewma: float = 0.3
    threshold: float = 1.35  # x median
    patience: int = 5


@dataclass
class Watchdog:
    cfg: StragglerConfig = field(default_factory=StragglerConfig)
    times: Dict[int, float] = field(default_factory=dict)
    strikes: Dict[int, int] = field(default_factory=dict)
    flagged: Dict[int, bool] = field(default_factory=dict)

    def observe(self, host: int, seconds: float) -> None:
        prev = self.times.get(host)
        a = self.cfg.ewma
        self.times[host] = seconds if prev is None else (1 - a) * prev + a * seconds

    def median(self) -> float:
        xs = sorted(self.times.values())
        if not xs:
            return 0.0
        n = len(xs)
        return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])

    def end_step(self) -> List[int]:
        """Update strike counters; returns hosts newly flagged this step."""
        med = self.median()
        newly = []
        if med <= 0:
            return newly
        for host, t in self.times.items():
            if t > self.cfg.threshold * med:
                self.strikes[host] = self.strikes.get(host, 0) + 1
                if self.strikes[host] >= self.cfg.patience and not self.flagged.get(host):
                    self.flagged[host] = True
                    newly.append(host)
            else:
                self.strikes[host] = 0
        return newly

    def plan(self, n_hosts: int) -> Dict:
        """Mitigation plan for the launcher."""
        bad = sorted(h for h, f in self.flagged.items() if f)
        if not bad:
            return {"action": "none"}
        live = [h for h in range(n_hosts) if h not in bad]
        return {
            "action": "remesh",
            "drop_hosts": bad,
            "live_hosts": live,
            # until the re-mesh lands, shrink the stragglers' data share:
            "reweight": {h: 0.5 for h in bad},
        }
