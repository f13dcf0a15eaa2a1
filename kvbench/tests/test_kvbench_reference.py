"""The plain reference against hand-worked cases, and the comparison."""

from types import SimpleNamespace

import numpy as np

from kvbench import check
from kvbench.reference import SortedMap

u = lambda *xs: np.array(xs, dtype=np.uint64)  # noqa: E731


def make():
    return SortedMap(u(10, 20, 30, 40), u(1, 2, 3, 4))


def test_get_after_update_reads_the_new_value():
    m = make()
    m.put(u(20), u(99))
    v, f = m.get(u(20, 30))
    assert v.tolist() == [99, 3] and f.tolist() == [True, True]


def test_an_absent_key_reads_zero_and_not_found():
    v, f = make().get(u(15, 50))
    assert v.tolist() == [0, 0] and f.tolist() == [False, False]


def test_the_last_write_of_a_batch_wins():
    m = make()
    m.put(u(20, 25, 20, 25), u(5, 6, 7, 8))
    v, f = m.get(u(20, 25))
    assert v.tolist() == [7, 8] and f.all()


def test_a_scan_crosses_an_insert_and_is_cut_to_its_length():
    m = make()
    m.put(u(25), u(250))
    k, v, c = m.scan(u(15, 35, 45), 3)
    assert k.tolist() == [[20, 25, 30], [40, 0, 0], [0, 0, 0]]
    assert v.tolist() == [[2, 250, 3], [4, 0, 0], [0, 0, 0]]
    assert c.tolist() == [3, 1, 0]
    # a request of length 2 compares only its first two rows and its count up to 2
    got = SimpleNamespace(keys=np.array([[20, 25, 77]], dtype=np.uint64), vals=np.array([[2, 250, 9]], dtype=np.uint64),
                          counts=np.array([3]))
    assert check.scan_wrong(got, np.array([2]), k[:1], v[:1], c[:1]) == 0
    assert check.scan_wrong(got, np.array([3]), k[:1], v[:1], c[:1]) == 1


def test_an_insert_then_an_update_of_it():
    m = make()
    m.put(u(5), u(50))
    m.put(u(5, 40), u(51, 41))
    k, v, c = m.scan(u(0), 5)
    assert k.tolist() == [[5, 10, 20, 30, 40]] and v.tolist() == [[51, 1, 2, 3, 41]]
    ik, iv = m.items()
    assert ik.tolist() == [5, 10, 20, 30, 40] and iv.tolist() == [51, 1, 2, 3, 41]


def test_get_wrong_counts_rows_whose_value_or_flag_differ():
    ev, ef = u(1, 2, 0), np.array([True, True, False])
    assert check.get_wrong(u(1, 2, 0), ef, ev, ef) == 0
    assert check.get_wrong(u(1, 3, 0), np.array([True, True, True]), ev, ef) == 2
