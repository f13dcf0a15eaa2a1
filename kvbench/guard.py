"""The import check: the benchmark measures the PyTorch port alone.

A module counts by its whole top-level name (the part before the first
dot), so ``repro_torch`` is not ``repro``."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})


def forbidden_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    """Top-level names in ``modules`` (default: ``sys.modules``) that belong
    to JAX, to the JAX package or to its benchmark harness."""
    names = sys.modules.keys() if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def require_clean(when: str) -> None:
    """Exit with code 3, naming what was found on standard error, if a
    forbidden module is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"kvbench: {when}: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        raise SystemExit(3)
