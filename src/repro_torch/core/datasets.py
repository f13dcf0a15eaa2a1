"""SOSD-style key distributions used by the paper's evaluation (Sec 4.1).

The real SOSD suite ships binary dumps of Facebook / Amazon / Wikipedia /
OpenStreetMap keys.  This container is offline, so we synthesise distributions
with the same *shape* characteristics that matter to a learned index:

  * ``sparse``    — uniform random over the full 64-bit space (paper: synthetic)
  * ``sparse_big``— same but sized to force tree depth 4 (paper: sparseBig)
  * ``dense4x``   — N keys sampled from a consecutive range of 4N (paper: dense4x)
  * ``wiki``      — timestamp-like: near-linear with mild jitter and duplicates
                    removed (wiki edit timestamps are ~piecewise linear -> low
                    PLA overhead, matching Table 1's 23 %)
  * ``amzn``      — book popularity ids: mixture of dense runs and heavy jumps
  * ``osmc``      — cell ids: clustered bursts with large voids (hardest for a
                    PLA; paper shows 74 % overhead at eps=8)
  * ``face``      — user ids: piecewise-uniform blocks with pathological gaps
                    (hardest in Table 1: 104 % at eps=8)

All generators are deterministic in ``seed`` and return **sorted unique**
``uint64`` keys, which is the contract bulk loading expects.
"""

from __future__ import annotations

import numpy as np

_FULL = np.float64(2.0**64)


def _finish(raw: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    keys = np.unique(raw.astype(np.uint64))
    # top up collisions so every dataset has exactly n keys
    while keys.size < n:
        extra = rng.integers(0, 2**63, size=(n - keys.size) * 2, dtype=np.uint64) * 2 + 1
        keys = np.unique(np.concatenate([keys, extra.astype(np.uint64)]))
    if keys.size > n:
        sel = rng.choice(keys.size, size=n, replace=False)
        keys = np.sort(keys[sel])
    return keys


def sparse(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2**64, size=int(n * 1.05), dtype=np.uint64)
    return _finish(raw, n, rng)


def sparse_big(n: int, seed: int = 0) -> np.ndarray:
    return sparse(n, seed=seed + 7)


def dense4x(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    base = np.uint64(rng.integers(0, 2**32))
    pool = rng.choice(4 * n, size=n, replace=False).astype(np.uint64) + base
    return np.sort(pool)


def wiki(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + 2)
    # timestamps: near-constant rate with bursty jitter
    gaps = rng.gamma(shape=0.9, scale=1200.0, size=n).astype(np.uint64) + 1
    raw = np.cumsum(gaps).astype(np.uint64) + np.uint64(1.4e18)
    return _finish(raw, n, rng)


def amzn(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + 3)
    # catalogue runs whose id *spacing drifts inside the run* (price-band /
    # category renumbering artefacts): PLA segments break at spacing shifts,
    # reproducing the paper's mid-pack 54 % overhead.
    runs = []
    remaining = int(n * 0.8)
    while remaining > 0:
        run_len = int(min(remaining, rng.integers(60, 400)))
        start = rng.integers(0, 2**48, dtype=np.uint64)
        # spacing re-drawn every ~40 ids
        pieces = []
        done = 0
        while done < run_len:
            m = int(min(run_len - done, rng.integers(20, 60)))
            step = np.uint64(rng.integers(1, 2000))
            base = pieces[-1][-1] + step if pieces else start
            pieces.append(base + step * np.arange(m, dtype=np.uint64))
            done += m
        runs.append(np.concatenate(pieces))
        remaining -= run_len
    scattered = rng.integers(0, 2**48, size=n - int(n * 0.8), dtype=np.uint64)
    raw = np.concatenate(runs + [scattered])
    return _finish(raw, n, rng)


def osmc(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + 4)
    # cell ids: many small clusters separated by enormous voids; within a
    # cluster keys are log-normally spaced -> PLA needs many short segments.
    n_clusters = max(1, n // 150)
    centers = np.sort(rng.integers(0, 2**62, size=n_clusters, dtype=np.uint64))
    sizes = rng.multinomial(n, np.ones(n_clusters) / n_clusters)
    parts = []
    for c, s in zip(centers, sizes):
        if s == 0:
            continue
        offs = np.cumsum(np.exp(rng.normal(4.0, 2.4, size=s))).astype(np.uint64)
        parts.append(c + offs)
    raw = np.concatenate(parts)
    return _finish(raw, n, rng)


def face(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + 5)
    # user ids allocated in short shards whose local density swings by
    # orders of magnitude every few dozen ids (allocator epochs): the PLA
    # can rarely hold a segment past a shard boundary — Table 1's worst case
    # (104 % overhead at eps=8).
    parts = []
    total = 0
    cursor = np.uint64(rng.integers(0, 2**60))
    while total < int(n * 1.02):
        m = int(rng.integers(8, 40))  # shard length << segment capacity
        scale = 2.0 ** rng.uniform(1, 34)  # density swings ~9 orders
        gaps = (rng.pareto(1.3, size=m) * scale + 1).astype(np.uint64)
        ids = cursor + np.cumsum(gaps).astype(np.uint64)
        parts.append(ids)
        cursor = ids[-1] + np.uint64(rng.integers(1, 2**38))
        total += m
    raw = np.concatenate(parts)
    return _finish(raw, n, rng)


DATASETS = {
    "sparse": sparse,
    "sparseBig": sparse_big,
    "dense4x": dense4x,
    "wiki": wiki,
    "amzn": amzn,
    "osmc": osmc,
    "face": face,
}


def load(name: str, n: int, seed: int = 0) -> np.ndarray:
    return DATASETS[name](n, seed)


def zipf_indices(n_keys: int, n_samples: int, alpha: float = 0.99, seed: int = 0) -> np.ndarray:
    """Zipf(alpha) ranks over a *shuffled* key order (hot keys spread out),
    as YCSB does. Returns indices into the sorted key array.

    Sampled by inverse-CDF over the n_keys bounded ranks: numpy's ``zipf``
    is unbounded rejection sampling whose acceptance rate collapses as
    alpha -> 1 (minutes per call at alpha=0.99); the truncated distribution
    it converges to is exactly this normalized bounded Zipf."""
    rng = np.random.default_rng(seed + 99)
    cdf = np.cumsum(1.0 / np.arange(1, n_keys + 1, dtype=np.float64) ** alpha)
    cdf /= cdf[-1]
    ranks = np.searchsorted(cdf, rng.random(n_samples), side="left") + 1
    perm = rng.permutation(n_keys)
    return perm[ranks - 1]
