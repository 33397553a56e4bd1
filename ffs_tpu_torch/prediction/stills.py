"""Stills reflection (re)prediction with delta-psi.

Equivalent of the reference simple_still_reflection_predictor (reference:
baseline/predictor/stills_predictor.cc:11-96): for known hkl, rotate the
reciprocal vector onto the Ewald sphere in its q/e1 plane, recording the
required rotation delpsi; fully vectorised.
"""

from __future__ import annotations

import numpy as np


def predict_stills(hkl: np.ndarray, s0: np.ndarray, ub: np.ndarray, panel) -> dict:
    """Returns dict with 's1' (N,3), 'xyzcal_px' (N,3), 'delpsi' (N,)."""
    hkl = np.asarray(hkl, dtype=np.float64)
    s0 = np.asarray(s0, dtype=np.float64)
    s0_len = np.linalg.norm(s0)
    unit_s0 = s0 / s0_len
    lam = 1.0 / s0_len

    q = hkl @ ub.T
    e1 = np.cross(q, unit_s0)
    e1 /= np.maximum(np.linalg.norm(e1, axis=1, keepdims=True), 1e-300)
    c0 = np.cross(unit_s0, e1)
    c0 /= np.maximum(np.linalg.norm(c0, axis=1, keepdims=True), 1e-300)
    qq = np.sum(q * q, axis=1)
    a = 0.5 * qq * lam
    b = np.sqrt(np.maximum(qq - a * a, 0.0))
    r = -a[:, None] * unit_s0 + b[:, None] * c0

    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-300)
    q1 = np.cross(qn, e1)
    q1 /= np.maximum(np.linalg.norm(q1, axis=1, keepdims=True), 1e-300)
    delpsi = -np.arctan2(np.einsum("ij,ij->i", r, q1), np.einsum("ij,ij->i", r, qn))

    v = s0 + r
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    s1 = v * s0_len

    xmm, ymm = panel.get_ray_intersection(s1)
    x_px, y_px = panel.mm_to_px(xmm, ymm)
    xyzcal_px = np.stack([x_px, y_px, np.zeros(len(hkl))], axis=1)
    return {"s1": s1, "xyzcal_px": xyzcal_px, "delpsi": delpsi}


def predict_laue_stills(
    hkl: np.ndarray,
    s0_unit: np.ndarray,
    ub: np.ndarray,
    wavelength_min: float,
    wavelength_max: float,
    dmin: float,
) -> dict:
    """Polychromatic (Laue) stills prediction
    (reference: ray_predictors.cc:204-220): each reflection selects the
    wavelength that puts it on its Ewald sphere; rays outside the bandpass
    or resolution limit are masked.  Returns 's1' (N, 3), 'wavenumber' (N,)
    and 'valid' (N,).  (The reference's rotational-Laue variant is an
    unimplemented stub, ray_predictors.cc:222-234.)"""
    s0_unit = np.asarray(s0_unit, dtype=np.float64)
    s0_unit = s0_unit / np.linalg.norm(s0_unit)
    r = np.asarray(hkl, dtype=np.float64) @ np.asarray(ub).T
    r_norm = np.linalg.norm(r, axis=1)
    r_hat = r / np.maximum(r_norm[:, None], 1e-300)
    denom = 2 * (r_hat @ s0_unit)
    with np.errstate(divide="ignore", invalid="ignore"):
        s0 = -r_norm / denom
    valid = (
        np.isfinite(s0)
        & (s0 >= 1.0 / wavelength_max)
        & (s0 <= 1.0 / wavelength_min)
        & (s0 <= 1.0 / dmin)
    )
    s0_safe = np.where(valid, s0, 0.0)
    s1 = s0_safe[:, None] * s0_unit + r
    return {"s1": s1, "wavenumber": s0_safe, "valid": valid}
