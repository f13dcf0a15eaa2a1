"""The generator: seeded, YCSB's distributions, fresh inserts."""

import numpy as np
import torch

from kvbench import traffic

CPU = torch.device("cpu")
TR = {
    "mix": {"scan": 0.9, "update": 0.05, "insert": 0.05},
    "request_distribution": "zipfian",
    "zipfian_constant": 0.99,
    "scan_length": {"distribution": "uniform", "min": 1, "max": 100},
    "stream_groups": 8,
}


def stream(seed, n=5000):
    keys = traffic.draw_sparse_keys(n, seed, CPU)
    return keys, traffic.draw_stream(keys, TR, 256, seed, CPU)


def test_keys_are_sorted_distinct_and_exclude_the_sentinel():
    k = traffic.to_u64(traffic.draw_sparse_keys(20000, 2**40 + 5, CPU))
    assert k.size == 20000 and (k[1:] > k[:-1]).all() and not (k == traffic.U64_MAX).any()


def test_the_same_seed_gives_the_same_stream_and_another_seed_another():
    _, a = stream(2**33 + 1)
    _, b = stream(2**33 + 1)
    _, c = stream(2**33 + 2)
    for f in ("read_keys", "scan_starts", "scan_lens", "write_keys", "write_vals"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.scan_starts, c.scan_starts)


def test_every_group_has_the_same_count_of_each_kind():
    _, s = stream(7)
    assert s.counts == {"read": 0, "scan": 230, "update": 13, "insert": 13}
    assert s.scan_starts.shape == (8, 230) and s.write_keys.shape == (8, 26)
    assert sum(traffic.kind_counts({"read": 0.95, "update": 0.05}, 65536).values()) == 65536


def test_zipfian_rank_shares_follow_ycsb():
    n, count, theta = 1000, 400_000, 0.99
    g = traffic.generator(CPU, 11, 2)
    r = traffic.zipf_ranks(n, count, theta, g, CPU).numpy()
    w = 1.0 / np.arange(1, n + 1) ** theta
    p = w / w.sum()
    got = np.bincount(r, minlength=n) / count
    for rank in (0, 1, 9, 99):
        assert abs(got[rank] - p[rank]) < 4 * np.sqrt(p[rank] / count) + 1e-4, rank
    assert r.min() >= 0 and r.max() < n


def test_scan_lengths_lie_in_one_to_a_hundred():
    _, s = stream(9)
    assert s.scan_lens.min() >= 1 and s.scan_lens.max() <= 100
    assert len(np.unique(s.scan_lens)) > 50


def test_inserts_are_fresh_and_unique_and_updates_hit_loaded_keys():
    keys, s = stream(13)
    loaded = traffic.to_u64(keys)
    ins = s.write_keys[:, 13:].reshape(-1)
    upd = s.write_keys[:, :13].reshape(-1)
    assert np.unique(ins).size == ins.size
    assert not np.isin(ins, loaded).any() and not (ins == traffic.U64_MAX).any()
    assert np.isin(upd, loaded).all()
    assert np.isin(s.scan_starts, loaded).all()


def test_each_pass_writes_values_of_its_own():
    assert traffic.pass_salt(0) == 0
    assert len({int(traffic.pass_salt(p)) for p in range(50)}) == 50


def test_a_fixed_data_seed_leaves_the_run_seed_the_order_and_the_values():
    _, s = stream(2**34 + 3)
    a, b = traffic.reorder(s, 101), traffic.reorder(s, 101)
    c = traffic.reorder(s, 102)
    assert np.array_equal(a.scan_starts, b.scan_starts) and np.array_equal(a.write_vals, b.write_vals)
    assert not np.array_equal(a.scan_starts, c.scan_starts)
    rows = lambda x: sorted(map(bytes, x.scan_starts))  # noqa: E731
    assert rows(a) == rows(s) == rows(c)
    assert not np.isin(a.write_vals, s.write_vals).all()
