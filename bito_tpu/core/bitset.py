"""Bitsets for clades, subsplits, and PCSPs.

JAX rebuild of the reference Bitset (reference: src/bitset.hpp:1-588,
src/bitset.cpp). Unlike the reference's dynamic bit-vector class, we represent a
bitset as an immutable Python int (arbitrary precision) plus an explicit bit
count.  Bit i of the integer corresponds to position i of the reference's
string representation (leftmost string char == bit 0 == taxon 0).

Three families of bitsets, as in the reference:
  - clade:    n bits, one per taxon.
  - subsplit: 2n bits = clade pair (clade0 | clade1).  The reference stores
    subsplits in "sorted order" where the first clade is the larger one under
    the bitset order (see src/bitset.cpp SubsplitOfPair); we reproduce that.
  - PCSP:     3n bits = sister|focal|child_subset (parent subsplit's two clades
    followed by the smaller child clade; see src/bitset.cpp PCSPOfPair).

These are host-side structures used for DAG/SBN bookkeeping; device compute
never touches them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Tuple


def bits_of_string(s: str) -> int:
    """'011' -> int with bit 1 and 2 set (string position i == bit i)."""
    v = 0
    for i, c in enumerate(s):
        if c == "1":
            v |= 1 << i
        elif c != "0":
            raise ValueError(f"Bad bitset string char: {c!r}")
    return v


def string_of_bits(v: int, n: int) -> str:
    # bit i of v lands at string position i (LSB first); format() keeps
    # this off the hot path (it dominated VBPI step profiles at 8s/step).
    # Mask to n bits first: an unmasked complement would otherwise yield a
    # string longer than n and corrupt subsplit/PCSP indexer keys.
    return format(v & ((1 << n) - 1), "b").zfill(n)[::-1]


def popcount(v: int) -> int:
    return bin(v).count("1")


def bit_indices(v: int) -> List[int]:
    out = []
    i = 0
    while v:
        if v & 1:
            out.append(i)
        v >>= 1
        i += 1
    return out


def clade_mask(taxa: Iterable[int]) -> int:
    v = 0
    for t in taxa:
        v |= 1 << t
    return v


def full_clade(n: int) -> int:
    return (1 << n) - 1


# The reference's bitset order is lexicographic on the string representation
# ("0" < "1" reading left to right).  With our bit encoding (string position i
# == bit i), comparing two clades a < b lexicographically means: at the lowest
# differing bit position i, a has 0 and b has 1.
def clade_less(a: int, b: int) -> bool:
    """Lexicographic comparison matching the reference Bitset operator< on the
    string representation (reference src/bitset.cpp operator<)."""
    if a == b:
        return False
    diff = a ^ b
    low = diff & -diff  # lowest differing bit
    return (a & low) == 0


def clade_cmp_key(v: int, n: int) -> Tuple[int, ...]:
    """Sort key giving the reference's lexicographic string order."""
    return tuple((v >> i) & 1 for i in range(n))


@dataclass(frozen=True, order=False)
class Subsplit:
    """A subsplit (pair of disjoint clades), stored in the reference's sorted
    order: clade0 is the lexicographically *larger* clade (reference
    src/bitset.cpp Bitset::Subsplit, which puts the bigger one first).

    For leaf subsplits the pair is (leaf_clade, 0).  The DAG root (UCA) is
    (full_clade, 0) -- actually the reference UCA subsplit is 0|full; see
    `uca`.
    """

    clade0: int
    clade1: int
    n: int

    @staticmethod
    def of_pair(a: int, b: int, n: int) -> "Subsplit":
        if a & b:
            raise ValueError("Subsplit clades must be disjoint")
        # Reference SubsplitOfPair: sorted so that the larger clade is first
        # half.  (src/bitset.cpp: "Subsplit(a, b) ... the order of the two
        # clades is sorted".)
        if clade_less(a, b):
            a, b = b, a
        return Subsplit(a, b, n)

    @property
    def union(self) -> int:
        return self.clade0 | self.clade1

    def to_string(self) -> str:
        return string_of_bits(self.clade0, self.n) + string_of_bits(self.clade1, self.n)

    def pretty(self) -> str:
        return string_of_bits(self.clade0, self.n) + "|" + string_of_bits(self.clade1, self.n)

    def rotate(self) -> "Subsplit":
        return Subsplit(self.clade1, self.clade0, self.n)

    def is_leaf(self) -> bool:
        return popcount(self.union) == 1

    def is_uca(self) -> bool:
        return self.union == full_clade(self.n) and (
            self.clade0 == 0 or self.clade1 == 0
        )

    def is_rootsplit(self) -> bool:
        return self.union == full_clade(self.n) and self.clade0 != 0 and self.clade1 != 0

    def sort_key(self):
        return clade_cmp_key(self.clade0, self.n) + clade_cmp_key(self.clade1, self.n)

    @staticmethod
    def leaf(taxon: int, n: int) -> "Subsplit":
        return Subsplit(1 << taxon, 0, n)

    @staticmethod
    def uca(n: int) -> "Subsplit":
        # Reference UCA subsplit: the DAG root node 11..1|00..0 sorted puts
        # the full clade first.
        return Subsplit(full_clade(n), 0, n)


@dataclass(frozen=True)
class PCSP:
    """Parent-child subsplit pair: 3n bits sister|focal|child_smaller_clade.

    Reference (src/bitset.cpp Bitset::PCSP, doc/concepts.rst): given parent
    subsplit S|F (sister S, focal F) and child subsplit of F into (U, V), the
    PCSP is  S | F | min(U, V)  where min is the bitset order. The child
    subsplit is recoverable because the larger child clade is F minus the
    stored clade.
    """

    sister: int
    focal: int
    child0: int  # the lexicographically smaller child clade
    n: int

    @staticmethod
    def of_parent_child(parent: Subsplit, child: Subsplit) -> "PCSP":
        n = parent.n
        # Which clade of the parent does the child split? The child's union
        # must equal one of the parent's clades.
        if child.union == parent.clade0:
            sister, focal = parent.clade1, parent.clade0
        elif child.union == parent.clade1:
            sister, focal = parent.clade0, parent.clade1
        else:
            raise ValueError("Child subsplit does not divide a parent clade")
        a, b = child.clade0, child.clade1
        small = a if clade_less(a, b) else b
        return PCSP(sister, focal, small, n)

    @property
    def parent(self) -> Subsplit:
        return Subsplit.of_pair(self.sister, self.focal, self.n)

    @property
    def child(self) -> Subsplit:
        return Subsplit.of_pair(self.child0, self.focal & ~self.child0, self.n)

    def to_string(self) -> str:
        return (
            string_of_bits(self.sister, self.n)
            + string_of_bits(self.focal, self.n)
            + string_of_bits(self.child0, self.n)
        )

    def pretty(self) -> str:
        return (
            string_of_bits(self.sister, self.n)
            + "|"
            + string_of_bits(self.focal, self.n)
            + "|"
            + string_of_bits(self.child0, self.n)
        )

    def sort_key(self):
        return (
            clade_cmp_key(self.sister, self.n)
            + clade_cmp_key(self.focal, self.n)
            + clade_cmp_key(self.child0, self.n)
        )

    def is_fake(self) -> bool:
        """A 'fake'/leaf PCSP has a leaf child (focal clade of size 1)."""
        return popcount(self.focal) == 1

    def is_rootsplit_pcsp(self) -> bool:
        return self.sister == 0 or self.focal | self.sister == full_clade(self.n)


# ---------------------------------------------------------------------------
# API-compat helpers (reference src/pybito.cpp bitset bindings:
# subsplit/pcsp factories, accessors, hash strings)
# ---------------------------------------------------------------------------
def subsplit(clade0: str, clade1: str) -> Subsplit:
    """bito.subsplit factory: clades as '0101' strings."""
    return Subsplit.of_pair(
        bits_of_string(clade0), bits_of_string(clade1), len(clade0)
    )


def pcsp(sister: str, focal: str, child: str) -> PCSP:
    """bito.pcsp factory from the three clade strings."""
    return PCSP(
        bits_of_string(sister), bits_of_string(focal), bits_of_string(child),
        len(sister),
    )


def subsplit_to_string(ss: Subsplit) -> str:
    return ss.pretty()


def subsplit_get_clade(ss: Subsplit, which: int) -> str:
    clade = ss.clade0 if which == 0 else ss.clade1
    return string_of_bits(clade, ss.n)


def subsplit_is_leaf(ss: Subsplit) -> bool:
    return ss.is_leaf()


def subsplit_is_rootsplit(ss: Subsplit) -> bool:
    return ss.is_rootsplit()


def subsplit_is_uca(ss: Subsplit) -> bool:
    return ss.is_uca()


def pcsp_to_string(p: PCSP) -> str:
    return p.pretty()


def pcsp_get_parent_subsplit(p: PCSP) -> Subsplit:
    return p.parent


def pcsp_get_child_subsplit(p: PCSP) -> Subsplit:
    return p.child


def clade_get_count(clade: str) -> int:
    return popcount(bits_of_string(clade))


def to_hash_string(obj) -> str:
    """Short content hash of a subsplit/PCSP (reference ToHashString)."""
    import hashlib

    return hashlib.sha1(obj.to_string().encode()).hexdigest()[:12]


subsplit_to_hash_string = to_hash_string
pcsp_to_hash_string = to_hash_string
