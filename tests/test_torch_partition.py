"""The port's Appendix-A partition (``repro_torch.core.partition``): the
properties of ``tests/test_partition.py``, and the same answers as
``repro.core.partition`` on every input."""
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # CI images without hypothesis: deterministic local shim
    from _hypothesis_shim import given, settings, strategies as st

from repro.core import partition as rpt
from repro_torch.core import partition as pt


def test_paper_example():
    """N=32, P=7 -> [5,5,5,5,4,4,4]; i=14 -> rank 2; i=27 -> rank 5."""
    np.testing.assert_array_equal(pt.counts(32, 7), [5, 5, 5, 5, 4, 4, 4])
    assert pt.index_to_rank(32, 7, 14) == 2
    assert pt.index_to_rank(32, 7, 27) == 5


def test_regular_case_more_homogeneous():
    """N=32, P=6: excess spread over the range, not piled on the front."""
    c = pt.counts(32, 6)
    assert c.sum() == 32
    assert c.max() - c.min() <= 1
    assert list(c) == [5, 5, 6, 5, 5, 6]


@settings(max_examples=300, deadline=None)
@given(n=st.integers(1, 5000), p=st.integers(1, 600))
def test_partition_is_a_partition(n, p):
    c = pt.counts(n, p)
    assert c.sum() == n
    assert (c >= 0).all()
    assert c.max() - c.min() <= 1


@settings(max_examples=300, deadline=None)
@given(n=st.integers(1, 3000), p=st.integers(1, 300))
def test_inverse_consistency(n, p):
    """index_to_rank is the exact inverse of the rank->range map."""
    ranks = np.arange(p)
    starts = pt.rank_first_index(n, p, ranks)
    ends = pt.rank_first_index(n, p, ranks + 1)
    idx = np.arange(n)
    owner = pt.index_to_rank(n, p, idx)
    assert ((idx >= starts[owner]) & (idx < ends[owner])).all()


@settings(max_examples=100, deadline=None)
@given(p=st.integers(1, 500), r=st.integers(0, 499))
def test_send_order_is_permutation_starting_at_neighbor(p, r):
    r = r % p
    order = pt.send_order(p, r)
    assert sorted(order) == list(range(p))
    assert order[0] == (r + 1) % p


@pytest.mark.parametrize("n,p", [(17, 4), (17, 2), (65, 8), (32, 7),
                                 (129, 6), (3, 8), (1000, 33)])
def test_matches_reference(n, p):
    """Every function gives the reference's answer, the node-centered N+1
    splits included."""
    ranks = np.arange(p + 1)
    idx = np.arange(n)
    np.testing.assert_array_equal(pt.counts(n, p), rpt.counts(n, p))
    np.testing.assert_array_equal(pt.rank_first_index(n, p, ranks),
                                  rpt.rank_first_index(n, p, ranks))
    np.testing.assert_array_equal(pt.rank_count(n, p, ranks[:-1]),
                                  rpt.rank_count(n, p, ranks[:-1]))
    np.testing.assert_array_equal(pt.index_to_rank(n, p, idx),
                                  rpt.index_to_rank(n, p, idx))
    for r in range(p):
        np.testing.assert_array_equal(pt.send_order(p, r),
                                      rpt.send_order(p, r))
