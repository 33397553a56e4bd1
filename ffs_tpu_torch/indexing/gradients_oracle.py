"""DIALS scan-static analytic prediction gradients — NumPy parity oracle.

The production refinement (ffs_tpu/indexing/refine.py) gets its Jacobian
from JAX forward-mode autodiff through the vectorised scan-static
predictor.  This module is the *independent check* on that Jacobian: the
hand-derived DIALS gradient expressions ∂(x_mm, y_mm, phi)/∂p evaluated
from a reflection's stored (s1, xyzcal.mm, hkl) and the current model
states (reference: baseline/refiner/gradients_calculator.cc:43-180 — the
published DIALS scan-static gradient math; like
ffs_tpu/prediction/reeke.py this is a deliberate parity oracle, not a
production path).

Two uses (tests/test_refine_dials_golden.py):

  1. evaluated with the reference GTest's exact inputs, it reproduces
     every pinned DIALS gradient number at 1e-12
     (reference: baseline/refiner/tests/test_gradients_calculator.cc);
  2. evaluated at a self-consistent state (reflection data predicted at
     that same state), it must equal the autodiff Jacobian of the
     production residual function — which is what certifies autodiff as
     a drop-in for DIALS' GradientsCalculator.
"""

from __future__ import annotations

import numpy as np


def _unit_rotate_around_origin(q: np.ndarray, axis: np.ndarray, angle: float):
    """Rotate q about the unit axis by angle (Rodrigues; dx2 convention)."""
    c, s = np.cos(angle), np.sin(angle)
    return q * c + axis * (axis @ q) * (1 - c) + np.cross(axis, q) * s


def scan_static_gradients(
    *,
    s1: np.ndarray,  # (N, 3) stored reflection s1
    xyzcal_mm: np.ndarray,  # (N, 3) stored calculated position (z = phi, rad)
    hkl: np.ndarray,  # (N, 3)
    U: np.ndarray,  # (3, 3) orientation state
    B: np.ndarray,  # (3, 3) cell state
    s0: np.ndarray,  # (3,) beam state
    d_matrix: np.ndarray,  # (3, 3) detector state, columns (fast, slow, origin)
    axis: np.ndarray,  # (3,) rotation axis
    setting_rotation: np.ndarray | None = None,  # S
    fixed_rotation: np.ndarray | None = None,  # F
    dbeam_dp: np.ndarray,  # (3, n_beam) ∂s0/∂p
    du_dp: np.ndarray,  # (3, 3, n_u) ∂U/∂p
    db_dp: np.ndarray,  # (3, 3, n_cell) ∂B/∂p
    dd_dp: np.ndarray,  # (3, 3, n_det) ∂d_matrix/∂p
) -> np.ndarray:
    """Analytic ∂(x_mm, y_mm, phi)/∂p for every parameter.

    Returns (n_beam + n_u + n_cell + n_det, 3 * N): each row is one
    parameter's gradient in the reference's residual layout
    [dx_0..dx_{N-1}, dy_0..dy_{N-1}, dphi_0..dphi_{N-1}]
    (gradients_calculator.cc:106-118).  Detector rows have zero dphi
    (the detector does not move the diffraction condition).
    """
    S = np.eye(3) if setting_rotation is None else np.asarray(setting_rotation)
    F = np.eye(3) if fixed_rotation is None else np.asarray(fixed_rotation)
    s1 = np.asarray(s1, dtype=np.float64)
    xyz = np.asarray(xyzcal_mm, dtype=np.float64)
    hkl = np.asarray(hkl, dtype=np.float64)
    n_ref = s1.shape[0]
    D = np.linalg.inv(np.asarray(d_matrix))
    UB = np.asarray(U) @ np.asarray(B)
    axis = np.asarray(axis, dtype=np.float64)

    # per-reflection frame quantities (gradients_calculator.cc:66-91)
    pv = s1 @ D.T
    w_inv = 1.0 / pv[:, 2]
    uw_inv = w_inv * pv[:, 0]
    vw_inv = w_inv * pv[:, 1]
    r = np.stack(
        [
            S @ _unit_rotate_around_origin(F @ (UB @ hkl[k]), axis, xyz[k, 2])
            for k in range(n_ref)
        ]
    )
    e_X_r = np.cross(S @ axis, r)
    e_r_s0 = e_X_r @ np.asarray(s0)

    def _rows(dpv, dphi):
        dx = w_inv * (dpv[:, 0] - dpv[:, 2] * uw_inv)
        dy = w_inv * (dpv[:, 1] - dpv[:, 2] * vw_inv)
        return np.concatenate([dx, dy, dphi])

    out = []
    # beam (gradients_calculator.cc:106-122): dphi = -(ds0 . r) / (e x r . s0)
    for j in range(np.asarray(dbeam_dp).shape[1]):
        db = np.asarray(dbeam_dp)[:, j]
        dphi = -(r @ db) / e_r_s0
        dpv = (e_X_r * dphi[:, None] + db) @ D.T
        out.append(_rows(dpv, dphi))
    # orientation (125-146): dr = S R(phi) F dU/dp B h; dphi = -(dr . s1)/...
    for j in range(np.asarray(du_dp).shape[2]):
        dU = np.asarray(du_dp)[:, :, j]
        dr = np.stack(
            [
                S
                @ _unit_rotate_around_origin(
                    F @ (dU @ (np.asarray(B) @ hkl[k])), axis, xyz[k, 2]
                )
                for k in range(n_ref)
            ]
        )
        dphi = -np.sum(dr * s1, axis=1) / e_r_s0
        dpv = (dr + e_X_r * dphi[:, None]) @ D.T
        out.append(_rows(dpv, dphi))
    # cell (148-169): same with dr from U dB/dp h
    for j in range(np.asarray(db_dp).shape[2]):
        dB = np.asarray(db_dp)[:, :, j]
        dr = np.stack(
            [
                S
                @ _unit_rotate_around_origin(
                    F @ (np.asarray(U) @ (dB @ hkl[k])), axis, xyz[k, 2]
                )
                for k in range(n_ref)
            ]
        )
        dphi = -np.sum(dr * s1, axis=1) / e_r_s0
        dpv = (dr + e_X_r * dphi[:, None]) @ D.T
        out.append(_rows(dpv, dphi))
    # detector (171-184): dpv = -D dd/dp D s1, no dphi
    for j in range(np.asarray(dd_dp).shape[2]):
        dd = np.asarray(dd_dp)[:, :, j]
        dpv = -(pv @ dd.T @ D.T)
        out.append(_rows(dpv, np.zeros(n_ref)))
    return np.stack(out)
