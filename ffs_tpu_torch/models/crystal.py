"""Crystal model: real-space lattice, A = UB decomposition, Niggli reduction.

Equivalent of the dx2 Crystal the reference builds from candidate lattice
vectors (reference: baseline/indexer/combinations.cc:85-92, which delegates
Niggli reduction to gemmi).  The reduction here is an independent
implementation of the standard Krivy & Gruber (1976) algorithm on the
metric-tensor parameters, tracking the integer change-of-basis so the
reduced vectors span exactly the same lattice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _cell_params(a, b, c):
    la, lb, lc = np.linalg.norm(a), np.linalg.norm(b), np.linalg.norm(c)
    alpha = np.degrees(np.arccos(np.clip(np.dot(b, c) / (lb * lc), -1, 1)))
    beta = np.degrees(np.arccos(np.clip(np.dot(a, c) / (la * lc), -1, 1)))
    gamma = np.degrees(np.arccos(np.clip(np.dot(a, b) / (la * lb), -1, 1)))
    return la, lb, lc, alpha, beta, gamma


def niggli_reduce_vectors(a, b, c, max_iter=10000):
    """Krivy-Gruber Niggli reduction of three lattice vectors.

    Returns reduced (a, b, c) spanning the same lattice.
    """
    vecs = np.array([a, b, c], dtype=np.float64)  # rows

    def params(m):
        A = np.dot(m[0], m[0])
        B = np.dot(m[1], m[1])
        C = np.dot(m[2], m[2])
        xi = 2 * np.dot(m[1], m[2])
        eta = 2 * np.dot(m[0], m[2])
        zeta = 2 * np.dot(m[0], m[1])
        return A, B, C, xi, eta, zeta

    vol = abs(np.linalg.det(vecs))
    eps = 1e-5 * vol ** (2.0 / 3.0) if vol > 0 else 1e-10

    def gt(x, y):
        return x > y + eps

    def lt(x, y):
        return x < y - eps

    def eq(x, y):
        return abs(x - y) <= eps

    for _ in range(max_iter):
        A, B, C, xi, eta, zeta = params(vecs)
        # step 1: order so A <= B
        if gt(A, B) or (eq(A, B) and gt(abs(xi), abs(eta))):
            vecs = np.array([-vecs[1], -vecs[0], -vecs[2]])
            continue
        # step 2: order so B <= C
        if gt(B, C) or (eq(B, C) and gt(abs(eta), abs(zeta))):
            vecs = np.array([-vecs[0], -vecs[2], -vecs[1]])
            continue
        # steps 3/4: normalise the signs of (xi, eta, zeta).  Flipping
        # vector i negates exactly the two parameters that contain it
        # (xi pairs b,c; eta a,c; zeta a,b), so a flip-set F negates
        # parameter p iff |F \ {p}| is odd.  Step 3 (xi*eta*zeta > 0 —
        # no zeros, an even number of negatives): flip the vectors of the
        # negative parameters, making all three positive.  Step 4
        # (otherwise): flip the vectors of the positive parameters,
        # borrowing a zero-parameter vector when the set is odd-sized,
        # making all three non-positive (Krivy & Gruber 1976 steps 3-4).
        sgn = [1 if gt(v, 0) else (-1 if lt(v, 0) else 0) for v in (xi, eta, zeta)]
        if 0 not in sgn and sgn.count(-1) % 2 == 0:
            flips = [idx for idx, s in enumerate(sgn) if s < 0]
        else:
            flips = [idx for idx, s in enumerate(sgn) if s > 0]
            if len(flips) % 2 == 1:
                zeros = [idx for idx, s in enumerate(sgn) if s == 0]
                # odd positives with no zeros would have an even number of
                # negatives and no zeros — a step-3 case — so a zero exists
                flips = flips + zeros[-1:] if zeros else []
        if flips:
            signs = np.ones(3)
            signs[flips] = -1.0
            vecs = signs[:, None] * vecs
            continue
        A, B, C, xi, eta, zeta = params(vecs)
        # step 5
        if gt(abs(xi), B) or (eq(xi, B) and lt(2 * eta, zeta)) or (
            eq(xi, -B) and lt(zeta, 0)
        ):
            s = 1 if xi > 0 else -1
            vecs = np.array([vecs[0], vecs[1], vecs[2] - s * vecs[1]])
            continue
        # step 6
        if gt(abs(eta), A) or (eq(eta, A) and lt(2 * xi, zeta)) or (
            eq(eta, -A) and lt(zeta, 0)
        ):
            s = 1 if eta > 0 else -1
            vecs = np.array([vecs[0], vecs[1], vecs[2] - s * vecs[0]])
            continue
        # step 7
        if gt(abs(zeta), A) or (eq(zeta, A) and lt(2 * xi, eta)) or (
            eq(zeta, -A) and lt(eta, 0)
        ):
            s = 1 if zeta > 0 else -1
            vecs = np.array([vecs[0], vecs[1] - s * vecs[0], vecs[2]])
            continue
        # step 8
        total = xi + eta + zeta + A + B
        if lt(total, 0) or (eq(total, 0) and gt(2 * (A + eta) + zeta, 0)):
            vecs = np.array([vecs[0], vecs[1], vecs[2] + vecs[0] + vecs[1]])
            continue
        break
    return vecs[0], vecs[1], vecs[2]


@dataclass
class Crystal:
    """P1 crystal defined by real-space lattice vectors (Angstroms)."""

    real_space_a: np.ndarray
    real_space_b: np.ndarray
    real_space_c: np.ndarray
    space_group: str = "P1"

    def __post_init__(self):
        self.real_space_a = np.asarray(self.real_space_a, dtype=np.float64)
        self.real_space_b = np.asarray(self.real_space_b, dtype=np.float64)
        self.real_space_c = np.asarray(self.real_space_c, dtype=np.float64)

    # --- geometry ---------------------------------------------------------

    @property
    def unit_cell(self) -> tuple[float, float, float, float, float, float]:
        return _cell_params(self.real_space_a, self.real_space_b, self.real_space_c)

    @property
    def volume(self) -> float:
        return float(
            abs(
                np.dot(
                    self.real_space_a,
                    np.cross(self.real_space_b, self.real_space_c),
                )
            )
        )

    @property
    def a_matrix(self) -> np.ndarray:
        """A = UB: columns are the reciprocal basis vectors a*, b*, c*,
        so rlp = A @ hkl and hkl = A^-1 @ rlp."""
        m = np.stack(
            [self.real_space_a, self.real_space_b, self.real_space_c]
        )  # rows
        return np.linalg.inv(m)  # columns of inv(rows) are a*, b*, c*

    @property
    def b_matrix(self) -> np.ndarray:
        """B: reciprocal orthogonalisation matrix from cell parameters alone
        (DIALS convention: A = U @ B with U orthonormal).

        Uses the DIALS/gemmi frame — B = inv(orth)^T where orth is the
        standard PDB orthogonalisation of the direct cell (a along x, b in
        the xy plane), giving a LOWER-triangular B whose columns are the
        reciprocal basis vectors: a* general, b* in the yz plane, c* along
        z.  This matches dx2/dxtbx ``Crystal::get_B`` bit-for-bit (verified
        against the DIALS golden state in
        tests/test_refine_dials_golden.py; reference:
        baseline/refiner/cell_parameterisation.cc:64-74 ``BG::back``).
        """
        a, b, c, al, be, ga = self.unit_cell
        al, be, ga = np.radians([al, be, ga])
        ca, cb, cg = np.cos(al), np.cos(be), np.cos(ga)
        sg = np.sin(ga)
        w = np.sqrt(max(0.0, 1 - ca * ca - cb * cb - cg * cg + 2 * ca * cb * cg))
        orth = np.array(
            [
                [a, b * cg, c * cb],
                [0.0, b * sg, c * (ca - cb * cg) / sg],
                [0.0, 0.0, c * w / sg],
            ]
        )
        return np.linalg.inv(orth).T

    @property
    def u_matrix(self) -> np.ndarray:
        return self.a_matrix @ np.linalg.inv(self.b_matrix)

    def niggli_reduce(self) -> "Crystal":
        a, b, c = niggli_reduce_vectors(
            self.real_space_a, self.real_space_b, self.real_space_c
        )
        return Crystal(a, b, c, self.space_group)

    # --- serialisation ------------------------------------------------------

    @classmethod
    def from_json(cls, obj: dict) -> "Crystal":
        sg = obj.get("space_group_hall_symbol", "P 1")
        return cls(
            np.asarray(obj["real_space_a"], dtype=float),
            np.asarray(obj["real_space_b"], dtype=float),
            np.asarray(obj["real_space_c"], dtype=float),
            space_group=sg,
        )

    def to_json(self) -> dict:
        return {
            "__id__": "crystal",
            "real_space_a": [float(v) for v in self.real_space_a],
            "real_space_b": [float(v) for v in self.real_space_b],
            "real_space_c": [float(v) for v in self.real_space_c],
            "space_group_hall_symbol": (
                "P 1" if self.space_group == "P1" else self.space_group
            ),
        }

    @classmethod
    def from_a_matrix(cls, a_matrix: np.ndarray) -> "Crystal":
        m = np.linalg.inv(np.asarray(a_matrix, dtype=np.float64))
        return cls(m[0], m[1], m[2])
