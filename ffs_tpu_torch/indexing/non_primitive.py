"""Systematic-absence (non-primitive basis) detection and correction.

Equivalent of the reference non_primitive_basis correction (reference:
baseline/indexer/non_primitive_basis.cc:16-226, the DIALS absence test):
detect exclusive modularity (mod 2, 3, 5) of hkl projections onto small
integer vectors, reindex the crystal with the corresponding transformation,
and reassign until no absence remains.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..models.crystal import Crystal
from .assign import assign_indices_global

_MODULARITIES = (2, 3, 5)


@lru_cache(maxsize=1)
def _sorted_points() -> np.ndarray:
    pts = []
    for i in range(5, -6, -1):
        for j in range(5, -6, -1):
            for k in range(5, -6, -1):
                pts.append((i, j, k))
    pts.remove((0, 0, 0))

    def key(p):
        # primary: closest to origin; secondary: higher sum first; tertiary:
        # reverse lexicographic so (1,0,0) precedes (0,1,0) precedes (0,0,1)
        return (
            p[0] ** 2 + p[1] ** 2 + p[2] ** 2,
            -(p[0] + p[1] + p[2]),
            tuple(-v for v in p),
        )

    return np.array(sorted(pts, key=key), dtype=np.int64)


@lru_cache(maxsize=1)
def generate_reindex_transformations():
    """(modularity, representative vector, transformation matrix) triples."""
    points = _sorted_points()
    reps: list[np.ndarray] = []
    for p in points:
        if p @ p > 6:
            break
        if any(np.array_equal(np.cross(p, r), (0, 0, 0)) for r in reps):
            continue
        reps.append(p)

    out = []
    for repr_v in reps:
        for mod in _MODULARITIES:
            cands = [p for p in points if (int(p @ repr_v) % mod) == 0]
            first = cands.pop(0)
            while True:
                second = cands.pop(0)
                if not np.array_equal(np.cross(second, first), (0, 0, 0)):
                    break
            normal = np.cross(second, first)
            while True:
                third = cands.pop(0)
                if int(normal @ third) != 0:
                    break
            A = np.array([first, second, third], dtype=np.float64)
            if np.linalg.det(A) < 0:
                A = np.array([second, first, third], dtype=np.float64)
            out.append((mod, repr_v, A))
    return out


def detect(hkl: np.ndarray, threshold: float = 0.9) -> np.ndarray | None:
    """Absence test over assigned (nonzero) hkls -> reindex matrix or None."""
    hkl = np.asarray(hkl, dtype=np.int64)
    n = len(hkl)
    if n == 0:
        return None
    for mod, vec, T in generate_reindex_transformations():
        pattern = hkl @ vec
        counts = np.bincount(np.mod(pattern, mod), minlength=mod)
        if counts[0] / n > threshold:
            return T
    return None


def correct(
    hkl: np.ndarray,
    crystal: Crystal,
    rlp: np.ndarray,
    xyzobs_mm: np.ndarray,
    threshold: float = 0.9,
) -> tuple[np.ndarray, Crystal, int]:
    """Iteratively remove detected absences.  Returns (hkl, crystal, count)."""
    hkl = np.asarray(hkl, dtype=np.int64)
    while True:
        sel = ~(hkl == 0).all(axis=1)
        count = int(sel.sum())
        if count == 0:
            break
        T = detect(hkl[sel], threshold)
        if T is None:
            break
        direct = np.linalg.inv(crystal.a_matrix)  # rows = real-space vectors
        M = np.linalg.inv(T).T
        new_direct = M @ direct
        crystal = Crystal(
            new_direct[0], new_direct[1], new_direct[2]
        ).niggli_reduce()
        hkl, count = assign_indices_global(crystal.a_matrix, rlp, xyzobs_mm)
    return hkl, crystal, count
