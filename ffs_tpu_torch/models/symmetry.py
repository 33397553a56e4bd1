"""Space-group symmetry from Hall symbols: systematic-absence filtering.

Equivalent of the reference's gemmi dependency for prediction (reference:
src/predictor/predict.cc:156-157 builds ``crystal.get_space_group().
operations()`` and the Reeke generators drop systematically-absent indices,
include/predictor/index_generators.hpp:83,462).  The .expt JSON stores the
space group as a Hall symbol (models/crystal.py), so this module implements
the published Hall-notation grammar (S.R. Hall, Acta Cryst. A37 (1981)
517-525; the same concise-symbol scheme gemmi/sgtbx parse) directly:
lattice centering letter, rotation fields with default-axis rules, screw
subscripts, glide/centering translation letters, optional origin shift.

Absence test (gemmi GroupOps::is_systematically_absent semantics): a
reflection h is absent iff some centering vector t has h.t not integral,
or some operation (R, t) maps h to itself (h' = h R, row-vector action)
with a non-integral phase h.t.  Vectorised over the whole hkl grid — one
(N, 3) @ (3, 3) matmul + modulo per operation, no per-hkl Python.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

DEN = 24  # translation denominator (all Hall translations are /24ths)

_I3 = np.eye(3, dtype=np.int64)

# principal-axis rotation matrices, column-vector action x' = R x
_PRINCIPAL = {
    ("2", "x"): [[1, 0, 0], [0, -1, 0], [0, 0, -1]],
    ("3", "x"): [[1, 0, 0], [0, 0, -1], [0, 1, -1]],
    ("4", "x"): [[1, 0, 0], [0, 0, -1], [0, 1, 0]],
    ("6", "x"): [[1, 0, 0], [0, 1, -1], [0, 1, 0]],
    ("2", "y"): [[-1, 0, 0], [0, 1, 0], [0, 0, -1]],
    ("3", "y"): [[-1, 0, 1], [0, 1, 0], [-1, 0, 0]],
    ("4", "y"): [[0, 0, 1], [0, 1, 0], [-1, 0, 0]],
    ("6", "y"): [[0, 0, 1], [0, 1, 0], [-1, 0, 1]],
    ("2", "z"): [[-1, 0, 0], [0, -1, 0], [0, 0, 1]],
    ("3", "z"): [[0, -1, 0], [1, -1, 0], [0, 0, 1]],
    ("4", "z"): [[0, -1, 0], [1, 0, 0], [0, 0, 1]],
    ("6", "z"): [[1, -1, 0], [1, 0, 0], [0, 0, 1]],
}

# two-fold axes along face diagonals; keyed by the PRECEDING field's axis
_DIAGONAL = {
    ("'", "z"): [[0, -1, 0], [-1, 0, 0], [0, 0, -1]],  # along a-b
    ('"', "z"): [[0, 1, 0], [1, 0, 0], [0, 0, -1]],  # along a+b
    ("'", "x"): [[-1, 0, 0], [0, 0, -1], [0, -1, 0]],  # along b-c
    ('"', "x"): [[-1, 0, 0], [0, 0, 1], [0, 1, 0]],  # along b+c
    ("'", "y"): [[0, 0, -1], [0, -1, 0], [-1, 0, 0]],  # along c-a
    ('"', "y"): [[0, 0, 1], [0, -1, 0], [1, 0, 0]],  # along c+a
}

_BODY_DIAGONAL_3 = [[0, 0, 1], [1, 0, 0], [0, 1, 0]]  # 3 about [111]

# translation letters, in 24ths
_TRANSLATIONS = {
    "a": (12, 0, 0),
    "b": (0, 12, 0),
    "c": (0, 0, 12),
    "n": (12, 12, 12),
    "u": (6, 0, 0),
    "v": (0, 6, 0),
    "w": (0, 0, 6),
    "d": (6, 6, 6),
}

_AXIS_VECTOR = {"x": (1, 0, 0), "y": (0, 1, 0), "z": (0, 0, 1)}

# lattice centering vectors, in 24ths (excluding the trivial one)
_CENTERING = {
    "P": [],
    "A": [(0, 12, 12)],
    "B": [(12, 0, 12)],
    "C": [(12, 12, 0)],
    "I": [(12, 12, 12)],
    "R": [(16, 8, 8), (8, 16, 16)],
    "F": [(0, 12, 12), (12, 0, 12), (12, 12, 0)],
}


def _norm_tran(t):
    return tuple(int(v) % DEN for v in t)


@dataclass(frozen=True)
class SymOp:
    rot: tuple  # 3x3 int, column-vector action
    tran: tuple  # length-3 int, in 24ths

    def matrix(self):
        return np.asarray(self.rot, dtype=np.int64)

    def __mul__(self, other: "SymOp") -> "SymOp":
        a, b = self.matrix(), other.matrix()
        rot = a @ b
        tran = a @ np.asarray(other.tran, dtype=np.int64) + np.asarray(
            self.tran, dtype=np.int64
        )
        return SymOp(tuple(map(tuple, rot.tolist())), _norm_tran(tran))


@dataclass
class GroupOps:
    """Closed set of symmetry operations + centering vectors."""

    sym_ops: list = field(default_factory=list)  # [SymOp], identity first
    cen_vecs: list = field(default_factory=list)  # [(3,) 24ths], no trivial

    # --- Hall parsing -------------------------------------------------------

    @classmethod
    def from_hall(cls, hall: str) -> "GroupOps":
        fields = hall.replace("_", " ").split()
        if not fields:
            raise ValueError(f"empty Hall symbol: {hall!r}")
        first = fields[0]
        centric = first.startswith("-")
        lattice = (first[1:] if centric else first).upper()
        if len(lattice) > 1:
            # compact form ("P1", "P212121" is NOT Hall — but a compact
            # lattice+field first token like "P1" does occur): split the
            # remainder back into the field list
            fields = [fields[0][: 2 if centric else 1], lattice[1:], *fields[1:]]
            lattice = lattice[0]
        if lattice not in _CENTERING:
            raise ValueError(f"unknown lattice symbol {lattice!r} in {hall!r}")

        generators = [SymOp(tuple(map(tuple, _I3.tolist())), (0, 0, 0))]
        if centric:
            generators.append(
                SymOp(tuple(map(tuple, (-_I3).tolist())), (0, 0, 0))
            )

        shift = None
        prev_axis = None
        prev_n = None
        n_rot_fields = 0
        for fld in fields[1:]:
            if fld.startswith("("):
                # origin shift "(va vb vc)" in 12ths, possibly split across
                # fields — reassemble from the remaining text
                txt = hall[hall.index("(") + 1 : hall.rindex(")")]
                shift = [int(v) * 2 for v in txt.split()]  # 12ths -> 24ths
                break
            n_rot_fields += 1
            op, axis = _parse_rotation_field(
                fld, n_rot_fields, prev_axis, prev_n, hall
            )
            generators.append(op)
            prev_axis, prev_n = axis, fld.lstrip("-")[0]

        ops = _close_group(generators)
        if shift is not None:
            v = np.asarray(shift, dtype=np.int64)
            moved = []
            for op in ops:
                t = np.asarray(op.tran, dtype=np.int64) + v - op.matrix() @ v
                moved.append(SymOp(op.rot, _norm_tran(t)))
            ops = moved

        # identity first, deterministic order for the rest
        ident = SymOp(tuple(map(tuple, _I3.tolist())), (0, 0, 0))
        rest = sorted(set(ops) - {ident}, key=lambda o: (o.rot, o.tran))
        return cls(sym_ops=[ident, *rest], cen_vecs=list(_CENTERING[lattice]))

    # --- queries -------------------------------------------------------------

    def __len__(self):
        return len(self.sym_ops) * (len(self.cen_vecs) + 1)

    def is_systematically_absent(self, hkl: np.ndarray) -> np.ndarray:
        """Vectorised gemmi-semantics absence test.

        hkl: (N, 3) integer array.  Returns (N,) bool.
        """
        h = np.asarray(hkl, dtype=np.int64)
        squeeze = h.ndim == 1
        h = np.atleast_2d(h)
        absent = np.zeros(len(h), dtype=bool)
        for cv in self.cen_vecs:
            absent |= (h @ np.asarray(cv, dtype=np.int64)) % DEN != 0
        for op in self.sym_ops[1:]:
            r = op.matrix()
            t = np.asarray(op.tran, dtype=np.int64)
            same = (h @ r == h).all(axis=1)  # h' = h R (row-vector action)
            absent |= same & ((h @ t) % DEN != 0)
        return absent[0] if squeeze else absent


def _parse_rotation_field(fld, index, prev_axis, prev_n, hall):
    """One Hall rotation field '[-]N[axis][translations/subscript]'."""
    s = fld
    improper = s.startswith("-")
    if improper:
        s = s[1:]
    if not s or s[0] not in "12346":
        raise ValueError(f"bad rotation field {fld!r} in {hall!r}")
    n = s[0]
    s = s[1:]

    axis = None
    tran = np.zeros(3, dtype=np.int64)
    screw = 0
    for ch in s:
        if ch in "xyz'\"*":
            axis = ch
        elif ch in _TRANSLATIONS:
            tran += np.asarray(_TRANSLATIONS[ch], dtype=np.int64)
        elif ch.isdigit():
            screw = int(ch)
        else:
            raise ValueError(f"bad char {ch!r} in Hall field {fld!r}")

    if axis is None:
        # Hall default-axis rules
        if n == "1":
            axis = "z"  # identity: axis irrelevant
        elif index == 1:
            axis = "z"
        elif index == 2 and n == "2":
            axis = "x" if prev_n in ("2", "4") else "'"
        elif index == 3 and n == "3":
            axis = "*"
        else:
            raise ValueError(
                f"cannot infer axis for field {fld!r} (position {index}) "
                f"in {hall!r}"
            )

    if n == "1":
        rot = _I3.copy()
    elif axis in ("'", '"'):
        if n != "2":
            raise ValueError(f"diagonal axis only valid for 2-fold: {fld!r}")
        base = prev_axis if prev_axis in ("x", "y", "z") else "z"
        rot = np.asarray(_DIAGONAL[(axis, base)], dtype=np.int64)
    elif axis == "*":
        if n != "3":
            raise ValueError(f"body-diagonal axis only valid for 3: {fld!r}")
        rot = np.asarray(_BODY_DIAGONAL_3, dtype=np.int64)
    else:
        rot = np.asarray(_PRINCIPAL[(n, axis)], dtype=np.int64)

    if screw:
        if axis not in _AXIS_VECTOR:
            raise ValueError(f"screw subscript on non-principal axis: {fld!r}")
        tran += (
            np.asarray(_AXIS_VECTOR[axis], dtype=np.int64) * (DEN * screw)
        ) // int(n)

    if improper:
        rot = -rot
    return (
        SymOp(tuple(map(tuple, rot.tolist())), _norm_tran(tran)),
        axis if axis in ("x", "y", "z") else prev_axis,
    )


def _close_group(generators, max_ops=192):
    ops = {SymOp(tuple(map(tuple, _I3.tolist())), (0, 0, 0))}
    frontier = list(generators)
    while frontier:
        new = []
        for g in frontier:
            for o in list(ops):
                for prod in (g * o, o * g):
                    if prod not in ops:
                        ops.add(prod)
                        new.append(prod)
        if len(ops) > max_ops:
            raise ValueError("group closure did not converge (bad symbol?)")
        frontier = new
    return list(ops)


def group_ops_from_symbol(symbol: str) -> GroupOps | None:
    """Best-effort GroupOps from a stored space-group string (Hall symbol
    as written by DIALS .expt files).  Returns None when the symbol cannot
    be parsed — callers fall back to no absence filtering, which is always
    correct (P1 superset) if suboptimal."""
    try:
        return GroupOps.from_hall(symbol)
    except Exception:
        return None
