"""Level vectors, combination coefficients and flop counts.

A verbatim copy of the pure-Python ``repro.core.levels``: importing the
reference module would run ``repro/core/__init__.py``, which imports
JAX, and this package imports neither JAX nor ``repro``.

Conventions (paper, Sect. 2):
  * A 1-D grid of refinement level ``l >= 1`` has ``2**l - 1`` interior points
    (no boundary points; level 1 is the single midpoint).
  * A combination grid is described by its level vector ``ell in N^d``.
  * The regular sparse grid of level ``n`` in ``d`` dims is combined from the
    grids with ``|ell|_1 in {n+d-1, ..., n}`` via inclusion-exclusion
    (Griebel/Schneider/Zenger 1992):

        u_n = sum_{q=0}^{d-1} (-1)^q C(d-1, q) sum_{|ell|_1 = n+d-1-q} u_ell
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from functools import cached_property, reduce
from typing import (Dict, Iterable, Iterator, Sequence, Set, Tuple, Union)

LevelVector = Tuple[int, ...]


def points_per_dim(level: int) -> int:
    """Number of grid points along one axis of refinement ``level``."""
    if level < 1:
        raise ValueError(f"refinement level must be >= 1, got {level}")
    return (1 << level) - 1


def grid_shape(levels: Sequence[int]) -> Tuple[int, ...]:
    """Array shape of the combination grid with level vector ``levels``."""
    return tuple(points_per_dim(l) for l in levels)


def num_points(levels: Sequence[int]) -> int:
    return reduce(lambda a, b: a * b, grid_shape(levels), 1)


def grid_bytes(levels: Sequence[int], dtype_bytes: int = 8) -> int:
    return num_points(levels) * dtype_bytes


def level_sums(levels: Sequence[int]) -> int:
    return int(sum(levels))


# ---------------------------------------------------------------------------
# Enumeration of level vectors
# ---------------------------------------------------------------------------

def level_vectors_with_sum(dim: int, levelsum: int, min_level: int = 1) -> Iterator[LevelVector]:
    """All level vectors ``ell >= min_level`` (componentwise) with |ell|_1 == levelsum."""
    if dim == 1:
        if levelsum >= min_level:
            yield (levelsum,)
        return
    for first in range(min_level, levelsum - (dim - 1) * min_level + 1):
        for rest in level_vectors_with_sum(dim - 1, levelsum - first, min_level):
            yield (first,) + rest


def combination_grids(dim: int, level: int) -> Iterator[Tuple[LevelVector, int]]:
    """(level_vector, coefficient) pairs of the classical combination technique.

    ``level`` is the sparse grid level ``n`` (target 1-D resolution); the
    diagonal cuts are ``|ell|_1 = n + d - 1 - q`` for ``q = 0..d-1`` with
    coefficient ``(-1)^q * C(d-1, q)``.
    """
    if level < 1:
        raise ValueError("sparse grid level must be >= 1")
    for q in range(min(dim, level)):
        coeff = (-1) ** q * math.comb(dim - 1, q)
        for ell in level_vectors_with_sum(dim, level + dim - 1 - q):
            yield ell, coeff


def sparse_grid_subspaces(dim: int, level: int) -> Iterator[LevelVector]:
    """Hierarchical subspaces W_m contained in the regular sparse grid."""
    for m in level_vectors_with_sum_at_most(dim, level + dim - 1):
        yield m


def level_vectors_with_sum_at_most(dim: int, max_sum: int) -> Iterator[LevelVector]:
    for s in range(dim, max_sum + 1):
        yield from level_vectors_with_sum(dim, s)


def subspaces_of_grid(levels: Sequence[int]) -> Iterator[LevelVector]:
    """All hierarchical subspaces W_m with m <= levels componentwise."""
    ranges = [range(1, l + 1) for l in levels]
    yield from (tuple(m) for m in itertools.product(*ranges))


def subspace_num_points(m: Sequence[int]) -> int:
    return reduce(lambda a, b: a * b, (1 << (mi - 1) for mi in m), 1)


def canonical_levels(levels: Sequence[int]) -> Tuple[LevelVector, Tuple[int, ...]]:
    """Descending-sorted level vector and the permutation realizing it.

    Returns ``(canon, perm)`` with ``canon[k] == levels[perm[k]]``.
    Hierarchization is a tensor-product operator, so transposing a grid to
    canonical axis order commutes with the transform — this is what lets
    the batched executor bucket all axis-permutations of one level multiset
    into a single kernel launch.
    """
    perm = tuple(sorted(range(len(levels)), key=lambda i: -levels[i]))
    return tuple(levels[i] for i in perm), perm


def fine_levels(scheme: "SchemeLike") -> LevelVector:
    """Per-axis maximum level over the scheme — the common fine grid every
    communication-phase realization embeds into.  Accepts anything with
    ``.dim`` and ``.grids`` (``CombinationScheme`` or ``GeneralScheme``)."""
    return tuple(max(ell[i] for ell, _ in scheme.grids)
                 for i in range(scheme.dim))


# ---------------------------------------------------------------------------
# Downward-closed index sets and inclusion-exclusion coefficients
# ---------------------------------------------------------------------------

def backward_neighbors(ell: LevelVector, min_level: int = 1
                       ) -> Iterator[LevelVector]:
    """``ell - e_i`` for every axis still above ``min_level``."""
    for i, li in enumerate(ell):
        if li > min_level:
            yield ell[:i] + (li - 1,) + ell[i + 1:]


def forward_neighbors(ell: LevelVector) -> Iterator[LevelVector]:
    """``ell + e_i`` for every axis."""
    for i, li in enumerate(ell):
        yield ell[:i] + (li + 1,) + ell[i + 1:]


def is_downward_closed(index_set: Iterable[LevelVector],
                       min_level: int = 1) -> bool:
    """True iff every backward neighbor of every member is a member."""
    iset = set(index_set)
    return all(b in iset for ell in iset
               for b in backward_neighbors(ell, min_level))


def downward_closure(levels: Iterable[LevelVector], min_level: int = 1
                     ) -> Tuple[LevelVector, ...]:
    """Smallest downward-closed set containing ``levels`` (sorted)."""
    seen: Set[LevelVector] = set()
    stack = [tuple(ell) for ell in levels]
    if not stack:
        raise ValueError("empty index set")
    for ell in stack:
        if any(l < min_level for l in ell):
            raise ValueError(f"level vector {ell} below min level {min_level}")
    while stack:
        ell = stack.pop()
        if ell in seen:
            continue
        seen.add(ell)
        stack.extend(backward_neighbors(ell, min_level))
    return tuple(sorted(seen))


def is_admissible(ell: LevelVector, index_set: Set[LevelVector],
                  min_level: int = 1) -> bool:
    """``index_set | {ell}`` stays downward closed."""
    return all(b in index_set for b in backward_neighbors(ell, min_level))


def admissible_extensions(index_set: Iterable[LevelVector],
                          min_level: int = 1) -> Tuple[LevelVector, ...]:
    """All level vectors NOT in the set whose addition keeps it downward
    closed — the dimension-adaptive candidate pool (sorted)."""
    iset = set(index_set)
    out = {n for ell in iset for n in forward_neighbors(ell)
           if n not in iset and is_admissible(n, iset, min_level)}
    return tuple(sorted(out))


def inclusion_exclusion_coefficients(index_set: Iterable[LevelVector]
                                     ) -> Dict[LevelVector, int]:
    """Combination coefficients of an arbitrary downward-closed set
    (Harding et al. / Griebel-Schneider-Zenger generalized):

        c_ell = sum_{z in {0,1}^d : ell + z in I} (-1)^{|z|_1}

    Returns only the NONZERO coefficients.  For the regular set
    ``{ell : |ell|_1 <= n + d - 1}`` this reproduces the classical
    ``(-1)^q C(d-1, q)`` diagonal coefficients.
    """
    iset = set(index_set)
    d = len(next(iter(iset)))
    out: Dict[LevelVector, int] = {}
    for ell in iset:
        c = 0
        for z in itertools.product((0, 1), repeat=d):
            if tuple(l + zi for l, zi in zip(ell, z)) in iset:
                c += (-1) ** sum(z)
        if c:
            out[ell] = c
    return out


def subspace_slices(m: Sequence[int], levels: Sequence[int]) -> Tuple[slice, ...]:
    """Strided slices extracting subspace W_m from the nodal-layout array of a
    combination grid with level vector ``levels``.

    Along axis i, level-m_i nodes sit at positions (2k+1)*2**(l_i - m_i),
    i.e. 0-based indices 2**(l_i - m_i) - 1 :: 2**(l_i - m_i + 1).
    """
    out = []
    for mi, li in zip(m, levels):
        if mi > li:
            raise ValueError(f"subspace level {mi} > grid level {li}")
        step = 1 << (li - mi)
        out.append(slice(step - 1, None, 2 * step))
    return tuple(out)


# ---------------------------------------------------------------------------
# Flop counts
# ---------------------------------------------------------------------------

def _prod_other(levels: Sequence[int], i: int) -> int:
    return reduce(lambda a, b: a * b,
                  ((1 << lj) - 1 for j, lj in enumerate(levels) if j != i), 1)


def flops_eq1(levels: Sequence[int]) -> int:
    """Paper Eq. (1), verbatim.  Used for 'calculated performance' plots."""
    return 2 * sum(((1 << li) - 2 * li - 2) * _prod_other(levels, i)
                   for i, li in enumerate(levels))


def predecessor_edges_1d(level: int) -> int:
    """Exact number of (node, predecessor) pairs in one pole: 2^{l+1}-2l-2."""
    return (1 << (level + 1)) - 2 * level - 2


def flops_exact(levels: Sequence[int]) -> int:
    """Instrumented flop count of Alg. 1 as written: 1 add + 1 mul per
    predecessor edge.  Exactly 2x Eq. (1); see DESIGN.md Sect. 1."""
    return 2 * sum(predecessor_edges_1d(li) * _prod_other(levels, i)
                   for i, li in enumerate(levels))


def muls_reduced(levels: Sequence[int]) -> int:
    """Multiplications after the flop-count reduction (paper Sect. 3):
    one multiply per updated node."""
    return sum(((1 << li) - 2) * _prod_other(levels, i)
               for i, li in enumerate(levels))


def adds_exact(levels: Sequence[int]) -> int:
    return flops_exact(levels) // 2


def hierarchization_bytes(levels: Sequence[int], dtype_bytes: int = 8,
                          passes: int | None = None) -> int:
    """Minimum HBM traffic: one read + one write of the full grid per pass.

    ``passes`` defaults to d (one pass per working dimension, the paper's
    algorithm); fused kernels lower it (DESIGN.md Sect. 2).
    """
    d = len(levels)
    if passes is None:
        passes = d
    return 2 * passes * grid_bytes(levels, dtype_bytes)


# ---------------------------------------------------------------------------
# Scheme dataclasses
# ---------------------------------------------------------------------------

def scheme_total_points(scheme: "SchemeLike") -> int:
    """Total points over the scheme's (nonzero-coefficient) grids."""
    return sum(num_points(ell) for ell, _ in scheme.grids)


def scheme_sparse_points(scheme: "SchemeLike") -> int:
    """Points of the sparse grid the scheme combines to."""
    return sum(subspace_num_points(m) for m in scheme.subspaces)


def scheme_partition_of_unity(scheme: "SchemeLike") -> bool:
    """Inclusion-exclusion sanity: every subspace the scheme resolves is
    covered with total coefficient exactly 1 (holds for the regular scheme
    and for ANY downward-closed general scheme)."""
    for m in scheme.subspaces:
        tot = sum(c for ell, c in scheme.grids
                  if all(mi <= li for mi, li in zip(m, ell)))
        if tot != 1:
            return False
    return True


@dataclass(frozen=True)
class CombinationScheme:
    """The set of combination grids and coefficients for one sparse grid."""

    dim: int
    level: int

    @cached_property
    def grids(self) -> Tuple[Tuple[LevelVector, int], ...]:
        return tuple(combination_grids(self.dim, self.level))

    @cached_property
    def subspaces(self) -> Tuple[LevelVector, ...]:
        return tuple(sparse_grid_subspaces(self.dim, self.level))

    def total_points(self) -> int:
        return scheme_total_points(self)

    def sparse_points(self) -> int:
        return scheme_sparse_points(self)

    def validate_partition_of_unity(self) -> bool:
        return scheme_partition_of_unity(self)

    def as_general(self) -> "GeneralScheme":
        """The same scheme as a ``GeneralScheme`` over the downward-closed
        set ``{ell : |ell|_1 <= level + dim - 1}`` — identical grids and
        coefficients, but open to refinement / grid dropping."""
        return GeneralScheme.regular(self.dim, self.level)


@dataclass(frozen=True)
class GeneralScheme:
    """Combination scheme over an ARBITRARY downward-closed index set.

    The index set ``I`` lists every hierarchical subspace the scheme
    resolves; the combination grids are the members with nonzero
    inclusion-exclusion coefficient
    ``c_ell = sum_{z in {0,1}^d, ell+z in I} (-1)^{|z|}``.  The classical
    regular scheme is the special case ``I = {ell : |ell|_1 <= n + d - 1}``
    (``GeneralScheme.regular``); dimension-adaptive refinement
    (``repro.core.adaptive``) grows ``I`` one admissible index at a time and
    fault handling (``repro.runtime.fault_tolerance.recombine_after_fault``)
    shrinks it.  Hashable, so ``build_plan``'s lru_cache and jit closures
    treat it exactly like ``CombinationScheme``.
    """

    dim: int
    index_set: Tuple[LevelVector, ...]

    def __post_init__(self):
        iset = tuple(sorted({tuple(int(l) for l in ell)
                             for ell in self.index_set}))
        if not iset:
            raise ValueError("empty index set")
        for ell in iset:
            if len(ell) != self.dim:
                raise ValueError(f"level vector {ell} is not {self.dim}-dim")
            if any(l < 1 for l in ell):
                raise ValueError(f"level vector {ell} below min level 1")
        if not is_downward_closed(iset):
            raise ValueError(
                "index set is not downward closed; use "
                "GeneralScheme.from_levels(..., close=True) to take the "
                "downward closure")
        object.__setattr__(self, "index_set", iset)

    # --- constructors ---

    @classmethod
    def from_levels(cls, levels: Iterable[LevelVector], *,
                    close: bool = False) -> "GeneralScheme":
        levels = tuple(tuple(ell) for ell in levels)
        if not levels:
            raise ValueError("empty index set")
        if close:
            levels = downward_closure(levels)
        return cls(dim=len(levels[0]), index_set=levels)

    @classmethod
    def regular(cls, dim: int, level: int) -> "GeneralScheme":
        """The classical scheme of ``CombinationScheme(dim, level)`` as a
        downward-closed set (same grids, same coefficients)."""
        if level < 1:
            raise ValueError("sparse grid level must be >= 1")
        iset = tuple(level_vectors_with_sum_at_most(dim, level + dim - 1))
        return cls(dim=dim, index_set=iset)

    # --- set refinement / reduction ---

    def with_levels(self, new_levels: Iterable[LevelVector]
                    ) -> "GeneralScheme":
        """Grow the index set (downward closure of the union)."""
        return GeneralScheme(
            self.dim, downward_closure(self.index_set + tuple(new_levels)))

    def without_levels(self, dropped: Iterable[LevelVector]
                       ) -> "GeneralScheme":
        """Shrink the index set: remove ``dropped`` AND every member
        dominating a dropped vector, so the result stays downward closed —
        the fault-handling reduction (a failed grid takes the subspaces only
        it resolved with it)."""
        dropped = [tuple(ell) for ell in dropped]
        keep = tuple(ell for ell in self.index_set
                     if not any(all(li >= di for li, di in zip(ell, dd))
                                for dd in dropped))
        if not keep:
            raise ValueError("dropping grids would empty the index set")
        return GeneralScheme(self.dim, keep)

    # --- scheme protocol (same surface as CombinationScheme) ---

    @cached_property
    def coefficients(self) -> Dict[LevelVector, int]:
        return inclusion_exclusion_coefficients(self.index_set)

    @cached_property
    def grids(self) -> Tuple[Tuple[LevelVector, int], ...]:
        c = self.coefficients
        return tuple((ell, c[ell]) for ell in self.index_set if ell in c)

    @cached_property
    def subspaces(self) -> Tuple[LevelVector, ...]:
        return self.index_set

    def total_points(self) -> int:
        return scheme_total_points(self)

    def total_bytes(self, dtype_bytes: int = 8) -> int:
        return self.total_points() * dtype_bytes

    def sparse_points(self) -> int:
        return scheme_sparse_points(self)

    def validate_partition_of_unity(self) -> bool:
        return scheme_partition_of_unity(self)


#: Anything the executor / communication phase accepts as a scheme: the
#: classical regular scheme or an arbitrary downward-closed general scheme
#: (duck-typed on ``.dim`` and ``.grids``).
SchemeLike = Union[CombinationScheme, GeneralScheme]
