"""Boundary conditions, data layouts, and the BC -> transform-kind planning.

This encodes Table I of the paper plus the periodic / unbounded cases:

    node-centered:  odd-odd -> DST-I,  odd-even -> DST-III,
                    even-odd -> DCT-III, even-even -> DCT-I
    cell-centered:  odd-odd -> DST-II, odd-even -> DST-IV,
                    even-odd -> DCT-IV, even-even -> DCT-II

Unbounded / semi-unbounded directions use the Hockney--Eastwood domain
doubling (section II-C): the FFT size doubles and the transform becomes a
DFT (fully unbounded) or the DCT/DST imposing the symmetry at the bounded
end (semi-unbounded).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class BCType(enum.Enum):
    EVEN = "even"
    ODD = "odd"
    PER = "periodic"
    UNB = "unbounded"


class DataLayout(enum.Enum):
    CELL = "cell"  # x_j = (j + 1/2) h, j in [0, N-1]
    NODE = "node"  # x_j = j h,         j in [0, N]


class TransformKind(enum.Enum):
    DFT_R2C = "dft_r2c"
    DFT_C2C = "dft_c2c"
    DCT1 = "dct1"
    DCT2 = "dct2"
    DCT3 = "dct3"
    DCT4 = "dct4"
    DST1 = "dst1"
    DST2 = "dst2"
    DST3 = "dst3"
    DST4 = "dst4"


# (left BC, right BC) -> transform kind, per data layout (paper Table I).
_TABLE_NODE = {
    (BCType.ODD, BCType.ODD): TransformKind.DST1,
    (BCType.ODD, BCType.EVEN): TransformKind.DST3,
    (BCType.EVEN, BCType.ODD): TransformKind.DCT3,
    (BCType.EVEN, BCType.EVEN): TransformKind.DCT1,
}
_TABLE_CELL = {
    (BCType.ODD, BCType.ODD): TransformKind.DST2,
    (BCType.ODD, BCType.EVEN): TransformKind.DST4,
    (BCType.EVEN, BCType.ODD): TransformKind.DCT4,
    (BCType.EVEN, BCType.EVEN): TransformKind.DCT2,
}

# Backward (inverse) kind for each forward r2r kind.
INVERSE_KIND = {
    TransformKind.DCT1: TransformKind.DCT1,
    TransformKind.DCT2: TransformKind.DCT3,
    TransformKind.DCT3: TransformKind.DCT2,
    TransformKind.DCT4: TransformKind.DCT4,
    TransformKind.DST1: TransformKind.DST1,
    TransformKind.DST2: TransformKind.DST3,
    TransformKind.DST3: TransformKind.DST2,
    TransformKind.DST4: TransformKind.DST4,
    TransformKind.DFT_R2C: TransformKind.DFT_R2C,
    TransformKind.DFT_C2C: TransformKind.DFT_C2C,
}


@dataclass(frozen=True)
class DirBC:
    """Boundary condition pair for one direction."""

    left: BCType
    right: BCType

    @property
    def is_periodic(self) -> bool:
        return self.left == BCType.PER or self.right == BCType.PER

    @property
    def is_unbounded(self) -> bool:
        return self.left == BCType.UNB and self.right == BCType.UNB

    @property
    def is_semi_unbounded(self) -> bool:
        return (self.left == BCType.UNB) != (self.right == BCType.UNB)

    @property
    def is_spectral(self) -> bool:
        """True when the direction needs no domain doubling."""
        return not (self.is_unbounded or self.is_semi_unbounded)

    def validate(self) -> None:
        if (self.left == BCType.PER) != (self.right == BCType.PER):
            raise ValueError("periodic BC must be imposed on both ends")


def r2r_kind(bc: DirBC, layout: DataLayout) -> TransformKind:
    """Transform kind for a fully symmetric (even/odd) direction."""
    table = _TABLE_NODE if layout == DataLayout.NODE else _TABLE_CELL
    return table[(bc.left, bc.right)]


def semi_unbounded_kind(bc: DirBC, layout: DataLayout) -> TransformKind:
    """Transform for a semi-unbounded direction on the *doubled* domain.

    The symmetry at the bounded end is imposed by the real-to-real
    transform; the unbounded end is handled by zero padding.  Following
    flups we always flip the data so the symmetric end sits at the left
    (j = 0); the doubled domain then behaves like a (sym, even) pair as
    the zero-padded far end is even-extendable without error.
    """
    sym = bc.left if bc.left != BCType.UNB else bc.right
    pair = (sym, BCType.EVEN)
    table = _TABLE_NODE if layout == DataLayout.NODE else _TABLE_CELL
    return table[pair]


def count_unbounded(bcs) -> int:
    return sum(1 for b in bcs if b.is_unbounded or b.is_semi_unbounded)
