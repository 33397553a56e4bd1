"""Spot-extent parameter estimation (sigma_b, sigma_m).

Equivalent of the reference estimate_sigmas (reference:
src/integrator/sigma_estimation.cc:20-172): quadrature sum of (a) the mean
spotfinder profile variances (sigma_b_variance / sigma_m_variance columns,
sigma_m restricted to spots spanning >= min_bbox_depth images) and (b) the
positional rmsd between predicted and observed centroids in Kabsch space
(with a 0.1 degree mis-prediction guard).

Deliberate divergence: when NO deep reflection passes the 0.1 degree guard
the reference divides 0/0 (sigma_estimation.cc:154 count_m==0) and returns a
NaN sigma_m; we use 0.0 so the profile term alone survives.
"""

from __future__ import annotations

import numpy as np

from ..models.reflection_table import INDEXED, USED_IN_REFINEMENT


def squaredev_in_kabsch_space(xyzcal_mm, xyzobs_mm, s0, panel, m2):
    """Per-reflection (varxy, varz) squared deviations (vectorised)."""
    s1cal = panel.get_lab_coord(xyzcal_mm[:, 0], xyzcal_mm[:, 1])
    s1obs = panel.get_lab_coord(xyzobs_mm[:, 0], xyzobs_mm[:, 1])
    dphi = xyzcal_mm[:, 2] - xyzobs_mm[:, 2]
    e1 = np.cross(s1cal, s0)
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(s1cal, e1)
    e2 /= np.linalg.norm(e2, axis=1, keepdims=True)
    zeta = e1 @ m2
    mags1 = np.linalg.norm(s1cal, axis=1)
    ds = s1obs - s1cal
    eps1 = np.einsum("ij,ij->i", ds, e1) / mags1
    eps2 = np.einsum("ij,ij->i", ds, e2) / mags1
    eps3 = dphi * zeta
    return eps1**2 + eps2**2, eps3**2


def estimate_sigmas(table, expt, min_bbox_depth: int = 6) -> tuple[float, float]:
    """Returns (sigma_b, sigma_m) in radians."""
    flags = np.asarray(table["flags"], dtype=np.uint64)
    used = (flags & USED_IN_REFINEMENT) != 0
    sel = used if used.any() else (flags & INDEXED) != 0
    if not sel.any():
        raise RuntimeError("No indexed reflections for sigma estimation")

    sb_var = np.asarray(table["sigma_b_variance"], dtype=np.float64)[sel]
    sm_var = np.asarray(table["sigma_m_variance"], dtype=np.float64)[sel]
    depth = np.asarray(table["spot_extent_z"])[sel]

    sigma_b_prof = np.sqrt(sb_var.mean())
    deep = depth >= min_bbox_depth
    if not deep.any():
        raise RuntimeError(
            "Unable to estimate sigma_m, no reflections above min_bbox_depth."
        )
    sigma_m_prof = np.sqrt(sm_var[deep].mean())

    xyzobs = np.asarray(table["xyzobs.mm.value"], dtype=np.float64)[sel]
    xyzcal = np.asarray(table["xyzcal.mm"], dtype=np.float64)[sel]
    varxy, varz = squaredev_in_kabsch_space(
        xyzcal,
        xyzobs,
        expt.beam.s0,
        expt.panel,
        expt.goniometer.rotation_axis,
    )
    # guard against mispredictions (> 0.1 deg positional deviation)
    ok = np.degrees(np.sqrt(varxy)) < 0.1
    if not ok.any():
        raise RuntimeError(
            "Unable to estimate rmsd deviation, predicted reflections are too "
            "far from observed"
        )
    rmsd_xy = np.sqrt(varxy[ok].mean())
    okz = ok & deep
    rmsd_z = np.sqrt(varz[okz].mean()) if okz.any() else 0.0

    sigma_b = float(np.sqrt(sigma_b_prof**2 + rmsd_xy**2))
    sigma_m = float(np.sqrt(sigma_m_prof**2 + rmsd_z**2))
    return sigma_b, sigma_m
