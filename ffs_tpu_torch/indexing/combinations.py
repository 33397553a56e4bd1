"""Candidate orientation matrices from basis-vector triples.

Equivalent of the reference CandidateOrientationMatrices (reference:
baseline/indexer/combinations.cc:22-102): all C(n<=100, 3) triples sorted by
squared index norm, right-handedness fixes, minimum-angle checks, Niggli
reduction and a volume sanity check.
"""

from __future__ import annotations

from itertools import combinations as _combinations

import numpy as np

from ..models.crystal import Crystal

_MIN_ANGLE = 20.0  # degrees


def _angle_deg(v1, v2):
    c = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2))
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def candidate_orientation_matrices(
    basis_vectors: list[np.ndarray], max_combinations: int = -1
):
    """Yields Niggli-reduced candidate Crystal models."""
    n = min(len(basis_vectors), 100)
    vecs = [np.asarray(v, dtype=np.float64) for v in basis_vectors[:n]]
    combs = sorted(
        _combinations(range(n), 3), key=lambda t: t[0] ** 2 + t[1] ** 2 + t[2] ** 2
    )
    if max_combinations > 0:
        combs = combs[:max_combinations]

    for i, j, k in combs:
        v1 = vecs[i].copy()
        v2 = vecs[j].copy()
        gamma = _angle_deg(v1, v2)
        if gamma < _MIN_ANGLE or (180 - gamma) < _MIN_ANGLE:
            continue
        crossprod = np.cross(v1, v2)
        if gamma < 90.0:
            v2 = -v2
            crossprod = -crossprod
        v3 = vecs[k].copy()
        if abs(90.0 - _angle_deg(crossprod, v3)) < _MIN_ANGLE:
            continue
        if _angle_deg(v2, v3) < 90.0:
            v3 = -v3
        if np.dot(crossprod, v3) < 0:
            v1, v2, v3 = -v1, -v2, -v3
        crystal = Crystal(v1, v2, v3).niggli_reduce()
        a, b, c, *_ = crystal.unit_cell
        if crystal.volume > (a * b * c / 100.0):
            yield crystal
