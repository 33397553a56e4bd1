"""Miller-index assignment.

Equivalent of the reference assign_indices_global (reference:
baseline/indexer/assign_indices.cc:36-167): hkl = round(A^-1 rlp), rejected
when |round(h) - h|^2 > tolerance^2 or hkl == (0,0,0); duplicate hkls within
pi/4 in phi keep only the closest assignment.  Fully vectorised.
"""

from __future__ import annotations

import numpy as np


def assign_indices_global(
    a_matrix: np.ndarray,
    rlp: np.ndarray,
    xyzobs_mm: np.ndarray,
    tolerance: float = 0.3,
) -> tuple[np.ndarray, int]:
    """Returns (miller_indices (N, 3) int, number_indexed)."""
    a_inv = np.linalg.inv(a_matrix)
    hkl_f = rlp @ a_inv.T
    hkl = np.round(hkl_f).astype(np.int64)
    l_sq = np.sum((hkl - hkl_f) ** 2, axis=1)

    ok = (l_sq <= tolerance * tolerance) & ~(hkl == 0).all(axis=1)
    hkl[~ok] = 0

    # duplicate resolution: for each duplicated hkl, pairwise keep-closest
    # among assignments within pi/4 in phi (assign_indices.cc:89-167)
    phi = np.asarray(xyzobs_mm)[:, 2]
    idx_ok = np.nonzero(ok)[0]
    if len(idx_ok):
        order = np.lexsort(
            (idx_ok, hkl[idx_ok, 2], hkl[idx_ok, 1], hkl[idx_ok, 0])
        )
        sorted_idx = idx_ok[order]
        keys = hkl[sorted_idx]
        boundaries = np.nonzero(np.any(np.diff(keys, axis=0) != 0, axis=1))[0] + 1
        groups = np.split(sorted_idx, boundaries)
        alive = ok.copy()
        for g in groups:
            if len(g) < 2:
                continue
            for i in range(len(g)):
                for j in range(i + 1, len(g)):
                    ir, jr = g[i], g[j]
                    if not (alive[ir] and alive[jr]):
                        continue
                    if abs(phi[ir] - phi[jr]) > np.pi / 4:
                        continue
                    loser = ir if l_sq[jr] < l_sq[ir] else jr
                    alive[loser] = False
                    hkl[loser] = 0
        ok = alive
    return hkl, int(ok.sum())
