"""Load-balanced, invertible distribution of unknowns (paper Appendix A).

A numpy-only copy of ``repro.core.partition``.  The distributed solver
pads its inactive axes to equal splits, as the reference does; this
module is the source of truth for how an uneven split would be laid out.

Distributes ``N`` unknowns over ``P`` ranks such that

* every rank owns at least ``B = N // P`` unknowns (the baseline),
* the ``R = N % P`` excess unknowns are spread over the whole rank range in
  ``R`` groups of stride ``S = P // R`` (the *last* rank of each group gets
  one extra), instead of piling up on the first ``R`` ranks,
* both directions are O(1) closed forms:
  ``rank -> first index`` (eq. 24)  and ``index -> rank`` (eqs. 25-).

This is what makes node-centered layouts (N+1 points on an even rank count)
load balanced across *nodes* and not only across ranks.

Also provides the congestion-avoiding send ordering of Appendix A.1: rank r
communicates with r+1, r+2, ... (rotated), never everyone-hits-rank-0.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "rank_first_index", "rank_count", "index_to_rank",
    "counts", "send_order",
]


def _bsr(n: int, p: int):
    b = n // p
    r = n % p
    s = p // r if r > 0 else p
    return b, r, s


def rank_first_index(n: int, p: int, rank) -> int:
    """First global index owned by ``rank`` (paper eq. 24)."""
    b, r, s = _bsr(n, p)
    rank = np.asarray(rank)
    return rank * b + np.minimum(rank // s, r)


def rank_count(n: int, p: int, rank) -> int:
    """Number of unknowns owned by ``rank``."""
    return rank_first_index(n, p, np.asarray(rank) + 1) - rank_first_index(
        n, p, rank)


def index_to_rank(n: int, p: int, idx) -> int:
    """Owning rank of global index ``idx`` (paper eqs. 25-)."""
    b, r, s = _bsr(n, p)
    idx = np.asarray(idx)
    if r == 0:
        return idx // b
    if b == 0:
        # one datum per group, owned by the group's last rank
        return idx * s + (s - 1)
    group = np.minimum(idx // (s * b + 1), r)          # eq. 25
    local = idx - group * (s * b + 1)                  # local data index
    local_rank = local // b
    # bound to S-1 inside full groups (the +1 data sits on the group's last rank)
    local_rank = np.where(group < r, np.minimum(local_rank, s - 1), local_rank)
    return group * s + local_rank


def counts(n: int, p: int) -> np.ndarray:
    """Per-rank counts, shape (p,)."""
    ranks = np.arange(p + 1)
    starts = rank_first_index(n, p, ranks)
    return np.diff(starts)


def send_order(p: int, rank: int) -> np.ndarray:
    """Destination ordering for rank ``rank`` (Appendix A.1).

    Rank r sends first to r+1, then r+2, ... wrapping around, so that send
    requests are spread over receivers instead of all hitting rank 0 first.
    """
    return (rank + 1 + np.arange(p)) % p
