"""The benchmark's traffic generator: the data of a deployment and a YCSB
operation stream, drawn from the run's seed on the device.

Frozen here, apart from the program, so that a later change of the program
cannot change what is measured:

* ``draw_sparse_keys``: ``n`` sorted unique u64 keys, uniform over u64 as
  YCSB's ``insertorder=hashed`` gives, made on the card (a copy of the
  method of ``chip_smoke.py:draw_sparse_keys``; the program's numpy
  ``datasets.sparse`` takes minutes at 50M keys).
* ``zipf_ranks``: YCSB's core ``ZipfianGenerator`` distribution over ``n``
  items (P(rank r) proportional to 1 / r^theta, r = 1..n), drawn by
  ``torch.searchsorted`` over its CDF; hot items are scattered over the key
  space by a seeded permutation, as YCSB's scrambled zipfian scatters them
  by a hash.
* ``draw_stream``: one general generator that reads a traffic file (the mix
  of reads, updates, inserts and scans, the request distribution, the scan
  lengths) and cuts the stream into groups of ``wave_size`` consecutive
  operations with the same count of each kind in every group.

u64 keys are held on the device as int64 with the top bit flipped
(``x ^ 2^63``), whose signed order is the unsigned order of ``x``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

SIGN = -(2**63)  # xor with this flips the top bit of an int64
U64_MAX = np.uint64(2**64 - 1)  # the store's reserved sentinel
KINDS = ("read", "scan", "update", "insert")


def generator(device, seed: int, salt: int) -> torch.Generator:
    """A generator on ``device`` for one purpose (``salt``) of one seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + salt) % 2**63)


def to_u64(x_flipped: torch.Tensor) -> np.ndarray:
    """Flipped int64 on the device -> u64 numpy on the host."""
    return (x_flipped ^ SIGN).cpu().numpy().view(np.uint64)


def draw_sparse_keys(n: int, seed: int, device) -> torch.Tensor:
    """``n`` sorted unique keys uniform over u64 (2^64 - 1 excluded), as
    flipped int64 on ``device``."""
    g = generator(device, seed, 1)
    x = torch.randint(-(2**63), 2**63 - 1, (n + n // 50 + 16,), generator=g, device=device, dtype=torch.int64)
    x = torch.unique(x)  # sorted: flipped order is u64 order
    x = x[x != 2**63 - 1]  # flipped 2^64 - 1
    keep = torch.sort(torch.randperm(x.numel(), generator=g, device=device)[:n]).values
    if keep.numel() < n:
        raise RuntimeError(f"drew {keep.numel()} distinct keys, wanted {n}")
    return x[keep]


def zipf_ranks(n_items: int, count: int, theta: float, g: torch.Generator, device) -> torch.Tensor:
    """``count`` 0-based ranks of YCSB's zipfian over ``n_items``."""
    cdf = torch.arange(1, n_items + 1, dtype=torch.float64, device=device).pow_(-theta).cumsum_(0)
    u = torch.rand(count, generator=g, dtype=torch.float64, device=device) * cdf[-1]
    ranks = torch.searchsorted(cdf, u)
    del cdf
    return ranks.clamp_(max=n_items - 1)


def kind_counts(mix: Dict[str, float], wave_size: int) -> Dict[str, int]:
    """Operations of each kind in one group: ``wave_size`` split by the mix,
    the remainder given to the largest fractions first."""
    total = sum(mix.get(k, 0.0) for k in KINDS)
    if abs(total - 1.0) > 1e-9 or set(mix) - set(KINDS):
        raise ValueError(f"mix must give shares of {KINDS} summing to 1, got {mix}")
    exact = {k: mix.get(k, 0.0) * wave_size for k in KINDS}
    out = {k: int(np.floor(v)) for k, v in exact.items()}
    rest = wave_size - sum(out.values())
    for k in sorted(KINDS, key=lambda k: exact[k] - out[k], reverse=True)[:rest]:
        out[k] += 1
    return out


@dataclass
class Stream:
    """The operation stream, host side: ``groups`` groups, each with the same
    count of every kind.  Row ``i`` of each array is group ``i``."""

    groups: int
    counts: Dict[str, int]
    read_keys: np.ndarray  # (G, n_read) u64
    scan_starts: np.ndarray  # (G, n_scan) u64
    scan_lens: np.ndarray  # (G, n_scan) int64, in [min, max]
    write_keys: np.ndarray  # (G, n_update + n_insert) u64: updates, then inserts
    write_vals: np.ndarray  # (G, n_update + n_insert) u64

    def group_ops(self) -> int:
        return sum(self.counts.values())


def pass_salt(p: int) -> np.uint64:
    """What the ``p``-th pass over the stream xors into its written values,
    so that each pass writes values of its own (pass 0 writes them as
    drawn)."""
    return np.uint64((p * 0x9E3779B97F4A7C15) % 2**64)


def draw_stream(keys: torch.Tensor, traffic: dict, wave_size: int, seed: int, device) -> Stream:
    """Draw ``traffic["stream_groups"]`` groups of ``wave_size`` operations
    over the loaded ``keys`` (sorted flipped int64 on ``device``)."""
    G = int(traffic["stream_groups"])
    counts = kind_counts(traffic["mix"], wave_size)
    n = keys.numel()
    g = generator(device, seed, 2)
    dist = traffic["request_distribution"]
    n_keyed = counts["read"] + counts["scan"] + counts["update"]
    total = G * n_keyed
    if dist == "zipfian":
        ranks = zipf_ranks(n, total, float(traffic["zipfian_constant"]), g, device)
        perm = torch.randperm(n, generator=g, device=device)
        idx = perm[ranks]
        del perm, ranks
    elif dist == "uniform":
        idx = torch.randint(0, n, (total,), generator=g, device=device)
    else:
        raise ValueError(f"request_distribution {dist!r}: zipfian or uniform")
    chosen = keys[idx].view(G, n_keyed)
    del idx
    nr, ns, nu, ni = counts["read"], counts["scan"], counts["update"], counts["insert"]
    read_keys = to_u64(chosen[:, :nr].reshape(-1)).reshape(G, nr)
    scan_starts = to_u64(chosen[:, nr : nr + ns].reshape(-1)).reshape(G, ns)
    upd_keys = chosen[:, nr + ns :]
    del chosen
    lens = traffic.get("scan_length", {"min": 1, "max": 1})
    if lens.get("distribution", "uniform") != "uniform":
        raise ValueError("scan_length: only the uniform distribution is drawn")
    scan_lens = torch.randint(int(lens["min"]), int(lens["max"]) + 1, (G, ns), generator=g, device=device)
    ins_keys = fresh_keys(keys, G * ni, g, device).view(G, ni)
    wk = torch.cat([upd_keys, ins_keys], dim=1)
    wv = torch.randint(-(2**63), 2**63 - 1, wk.shape, generator=g, device=device, dtype=torch.int64)
    return Stream(
        groups=G,
        counts=counts,
        read_keys=read_keys,
        scan_starts=scan_starts,
        scan_lens=scan_lens.cpu().numpy().astype(np.int64),
        write_keys=to_u64(wk.reshape(-1)).reshape(G, nu + ni),
        write_vals=to_u64(wv.reshape(-1)).reshape(G, nu + ni),
    )


def reorder(stream: Stream, seed: int) -> Stream:
    """The same groups in an order drawn from ``seed``, writing values of
    their own: what a run's seed changes where the traffic fixes its data
    (``data_seed``)."""
    perm = np.random.default_rng([int(seed), 0x0D3]).permutation(stream.groups)
    salt = np.uint64(np.random.default_rng([int(seed), 0x5A1]).integers(0, 2**63, dtype=np.int64))
    return Stream(
        groups=stream.groups,
        counts=stream.counts,
        read_keys=stream.read_keys[perm],
        scan_starts=stream.scan_starts[perm],
        scan_lens=stream.scan_lens[perm],
        write_keys=stream.write_keys[perm],
        write_vals=stream.write_vals[perm] ^ salt,
    )


def fresh_keys(keys: torch.Tensor, m: int, g: torch.Generator, device) -> torch.Tensor:
    """``m`` distinct keys uniform over u64 that are not among ``keys``
    (sorted flipped int64), in a random order, 2^64 - 1 excluded."""
    if m == 0:
        return torch.empty(0, dtype=torch.int64, device=device)
    x = torch.randint(-(2**63), 2**63 - 1, (m + m // 8 + 64,), generator=g, device=device, dtype=torch.int64)
    x = torch.unique(x)
    pos = torch.searchsorted(keys, x).clamp_(max=keys.numel() - 1)
    x = x[(keys[pos] != x) & (x != 2**63 - 1)]
    if x.numel() < m:
        raise RuntimeError(f"drew {x.numel()} fresh keys, wanted {m}")
    return x[torch.randperm(x.numel(), generator=g, device=device)[:m]]
