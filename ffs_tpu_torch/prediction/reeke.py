"""Reeke loop-limit Miller index enumeration (direct port, parity oracle).

Faithful NumPy port of the reference's resumable ReekeIndexGenerator
(reference: include/predictor/index_generators.hpp:27-388): per-h k-limits
and per-(h,k) l-limit slice pairs from the Ewald spheres at the image's
start/end orientations intersected with the resolution sphere.

The port's predictor (:mod:`ffs_tpu_torch.prediction.rotation`) instead
tests a conservative resolution-limited hkl grid on the device — the
Reeke limits enumerate a strict subset of that grid, so the two predictors
must yield identical reflection sets after the Ewald-crossing ray test.
tests/test_torch_prediction.py asserts exactly that, through the blocked
search; this module is the evidence that nothing outside the grid could
ever diffract.  A copy of the JAX package's module of the same path
(NumPy only).
"""

from __future__ import annotations

import math

import numpy as np


def _t_matrix(A: np.ndarray, s0: np.ndarray) -> np.ndarray:
    """T = P^T P for the 3x4 augmented orientation matrix P = [A | s0]."""
    P = np.hstack([np.asarray(A, float), np.asarray(s0, float).reshape(3, 1)])
    return P.T @ P


def _minmax_pair(p1, p2):
    vals = []
    for p in (p1, p2):
        if p is not None:
            vals.extend(p)
    if not vals:
        return None
    return (min(vals), max(vals))


def _h_limits_resolution(a, s0, dmin):
    """h extremes over the Ewald/resolution intersection circle.

    Documented divergence: the reference's formula
    (index_generators.hpp:126-137) returns e +- rho with rho the circle
    radius in A^-1 — dimensionally it is missing the projection of the
    circle onto the h axis, |a_perp| (the real-axis component
    perpendicular to s0).  Points r on the circle have
    h = r.a = k0 (s0_hat.a) + rho |a_perp| cos(phi), so the half-width is
    rho * |a_perp|; without it the h range collapses to ~+-dstar and the
    enumeration drops nearly every candidate whenever the resolution
    clamp engages.  We restore the LURE-notes geometry here; the parity
    test (tests/test_prediction.py::test_reeke_limits_parity) then proves
    the enumeration selects exactly the grid predictor's reflections.
    """
    dstar_max = 1.0 / dmin
    s0_len_sq = float(s0 @ s0)
    s0_len = math.sqrt(s0_len_sq)
    s0_dot_a = float(s0 @ a)
    e = -dstar_max * dstar_max * s0_dot_a / (2 * s0_len_sq)
    rho = dstar_max * math.sqrt(
        max(0.0, 1 - dstar_max * dstar_max / (4 * s0_len_sq))
    )
    a_perp_sq = float(a @ a) - (s0_dot_a / s0_len) ** 2
    f = rho * math.sqrt(max(a_perp_sq, 0.0))
    return (e - f, e + f)


def _h_limits(A1, A2, s0_1, s0_2, dmin):
    a1 = np.linalg.inv(A1)[0, :]
    a2 = np.linalg.inv(A2)[0, :]
    a1_len, a2_len = np.linalg.norm(a1), np.linalg.norm(a2)
    s0_1_len, s0_2_len = np.linalg.norm(s0_1), np.linalg.norm(s0_2)
    s0_1_dot_a1 = float(s0_1 @ a1)
    s0_2_dot_a2 = float(s0_2 @ a2)

    h1 = [-a1_len * s0_1_len - s0_1_dot_a1, a1_len * s0_1_len - s0_1_dot_a1]
    h2 = [-a2_len * s0_2_len - s0_2_dot_a2, a2_len * s0_2_len - s0_2_dot_a2]
    hr1 = _h_limits_resolution(a1, s0_1, dmin)
    hr2 = _h_limits_resolution(a2, s0_2, dmin)

    inv_d2 = 1.0 / (dmin * dmin)
    if 2 * (s0_1_len**2 + abs(s0_1_len * s0_1_dot_a1) / a1_len) > inv_d2:
        h1[0] = hr1[0]
    if 2 * (s0_1_len**2 - abs(s0_1_len * s0_1_dot_a1) / a1_len) > inv_d2:
        h1[1] = hr1[1]
    if 2 * (s0_2_len**2 + abs(s0_2_len * s0_2_dot_a2) / a2_len) > inv_d2:
        h2[0] = hr2[0]
    if 2 * (s0_2_len**2 - abs(s0_2_len * s0_2_dot_a2) / a2_len) > inv_d2:
        h2[1] = hr2[1]

    p1 = tuple(h1) if h1[0] <= h1[1] else None
    p2 = tuple(h2) if h2[0] <= h2[1] else None
    mm = _minmax_pair(p1, p2)
    if mm is None:
        return None
    return (int(mm[0]), int(mm[1]) + 1)


def _k_limits_ewald(T, h):
    r0 = T[2, 3] ** 2 + h * (
        2 * (T[0, 2] * T[2, 3] - T[0, 3] * T[2, 2])
        + h * (T[0, 2] ** 2 - T[0, 0] * T[2, 2])
    )
    r1 = T[1, 2] * T[2, 3] - T[1, 3] * T[2, 2] + h * (
        T[0, 2] * T[1, 2] - T[0, 1] * T[2, 2]
    )
    r2 = T[1, 2] ** 2 - T[1, 1] * T[2, 2]
    if r2 == 0:
        return None
    d = r1 * r1 - r0 * r2
    if d < 0:
        return None
    a = int((-r1 + math.sqrt(d)) / r2)
    b = int((-r1 - math.sqrt(d)) / r2) + 1
    return (a, b)


def _k_limits_resolution(T, h, dmin):
    r0 = h * h * (T[0, 2] ** 2 - T[0, 0] * T[2, 2]) + T[2, 2] / (dmin * dmin)
    r1 = h * (T[0, 2] * T[1, 2] - T[0, 1] * T[2, 2])
    r2 = T[1, 2] ** 2 - T[1, 1] * T[2, 2]
    if r2 == 0:
        return None
    d = r1 * r1 - r0 * r2
    if d < 0:
        return None
    a = int((-r1 + math.sqrt(d)) / r2)
    b = int((-r1 - math.sqrt(d)) / r2) + 1
    return (a, b)


def _k_limits(T1, T2, h, dmin):
    ke1 = _k_limits_ewald(T1, h)
    ke2 = _k_limits_ewald(T2, h)
    kr = _k_limits_resolution(T1, h, dmin)
    if kr is None:
        return None
    mm = _minmax_pair(ke1, ke2)
    if mm is None:
        return None
    # the reference clamps with kr's (first, second) as-is, not re-ordered
    lo = max(mm[0], kr[0])
    hi = min(mm[1], kr[1])
    return (lo, hi)


def _l_limits_ewald(T, h, k):
    q0 = (
        T[0, 0] * h * h
        + 2 * T[0, 1] * h * k
        + T[1, 1] * k * k
        + 2 * T[0, 3] * h
        + 2 * T[1, 3] * k
    )
    q1 = T[0, 2] * h + T[1, 2] * k + T[2, 3]
    q2 = T[2, 2]
    if q2 == 0:
        return None
    d = q1 * q1 - q0 * q2
    if d < 0:
        return None
    a = int((-q1 - math.sqrt(d)) / q2)
    b = int((-q1 + math.sqrt(d)) / q2) + 1
    return (a, b)


def _l_limits_resolution(T, h, k, dmin):
    q0 = (
        T[0, 0] * h * h
        + 2 * T[0, 1] * h * k
        + T[1, 1] * k * k
        - 1.0 / (dmin * dmin)
    )
    q1 = T[0, 2] * h + T[1, 2] * k
    q2 = T[2, 2]
    if q2 == 0:
        return None
    d = q1 * q1 - q0 * q2
    if d < 0:
        return None
    a = int((-q1 - math.sqrt(d)) / q2)
    b = int((-q1 + math.sqrt(d)) / q2) + 1
    return (a, b)


def _l_limits(T1, T2, h, k, dmin, use_monochromatic=True):
    le1 = _l_limits_ewald(T1, h, k)
    le2 = _l_limits_ewald(T2, h, k)
    lr = _l_limits_resolution(T1, h, k, dmin)
    if lr is None:
        return [None, None]

    slices = [None, None]
    if use_monochromatic:
        if le1 is not None and le2 is not None:
            # thin slices around the min pair and the max pair
            slices[0] = (min(le1[0], le2[0]), max(le1[0], le2[0]) + 1)
            slices[1] = (min(le1[1], le2[1]) - 1, max(le1[1], le2[1]))
        elif le1 is not None:
            slices[0] = le1
        elif le2 is not None:
            slices[1] = le2
        else:
            return [None, None]
    else:
        if le1 is not None:
            slices[0] = le1
        elif le2 is not None:
            slices[1] = le2
        else:
            return [None, None]

    out = [None, None]
    for i in range(2):
        if slices[i] is None:
            continue
        lo, hi = slices[i]
        lo = max(lo, lr[0])
        hi = min(hi, lr[1])
        if lo < hi:
            out[i] = (lo, hi)

    # order + merge overlapping ranges, matching the reference exactly
    if out[0] is not None and out[1] is not None:
        if out[0][0] > out[1][0]:
            out[0], out[1] = out[1], out[0]
        if out[1][0] <= out[0][1]:
            out[0] = (out[0][0], max(out[0][1], out[1][1]))
            out[1] = None
    return out


def reeke_indices(
    A1: np.ndarray,
    A2: np.ndarray,
    s0_1: np.ndarray,
    s0_2: np.ndarray,
    dmin: float,
    use_monochromatic: bool = True,
    group_ops=None,
) -> np.ndarray:
    """All candidate Miller indices for one image's rotation interval.

    ``group_ops`` (models/symmetry.GroupOps) drops systematically-absent
    indices like the reference's gemmi filter inside the generator loop
    (index_generators.hpp:83); None keeps the full P1 enumeration.
    """
    A1 = np.asarray(A1, float)
    A2 = np.asarray(A2, float)
    s0_1 = np.asarray(s0_1, float)
    s0_2 = np.asarray(s0_2, float)
    T1 = _t_matrix(A1, s0_1)
    T2 = _t_matrix(A2, s0_2)

    out = []
    h_lims = _h_limits(A1, A2, s0_1, s0_2, dmin)
    if h_lims is None:
        return np.zeros((0, 3), dtype=np.int64)
    for h in range(h_lims[0], h_lims[1] + 1):
        k_lims = _k_limits(T1, T2, h, dmin)
        if k_lims is None:
            continue
        for k in range(k_lims[0], k_lims[1] + 1):
            for lim in _l_limits(T1, T2, h, k, dmin, use_monochromatic):
                if lim is None:
                    continue
                for l in range(lim[0], lim[1] + 1):
                    out.append((h, k, l))
    if not out:
        return np.zeros((0, 3), dtype=np.int64)
    hkl = np.asarray(out, dtype=np.int64)
    if group_ops is not None:
        hkl = hkl[~group_ops.is_systematically_absent(hkl)]
    return hkl
