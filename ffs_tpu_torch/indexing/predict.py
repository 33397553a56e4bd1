"""Scan-static reflection (re)prediction.

Equivalent of the reference simple_reflection_predictor (reference:
baseline/predictor/scan_static_predictor.cc:43-180): for known hkl +
entering flags, solve the rotation angles where the rotated reciprocal
vector meets the Ewald sphere, pick the root matching the entering sign,
intersect with the detector, and report xyzcal.mm with the phi residual
folded onto the observed turn.

Two twins: a NumPy version for host pipelines and a jnp version used inside
the autodiff refinement loop (ffs_tpu/indexing/refine.py) — fully
vectorised over reflections, with validity masks instead of early exits.
"""

from __future__ import annotations

import numpy as np

TWO_PI = 2.0 * np.pi


def _mod2pi(angle, xp):
    angle = xp.where(xp.abs(angle - TWO_PI) <= 1e-7, TWO_PI, angle)
    return angle - TWO_PI * xp.floor(angle / TWO_PI)


def predict_scan_static(
    hkl,
    entering,
    phi_obs,
    *,
    s0,
    fixed_rotation,
    setting_rotation,
    rotation_axis,
    ub,
    d_matrix,
    xp=np,
):
    """Vectorised scan-static prediction.

    Parameters mirror the reference's model inputs; ``d_matrix`` columns are
    (fast, slow, origin) in mm so lab = d_matrix @ (x_mm, y_mm, 1).

    Returns dict with 'xyzcal_mm' (N, 3) where z is the matched angle folded
    onto the observed phi's turn, 's1' (N, 3), and 'valid' (N,) — False
    where no diffraction solution exists (reference clears the predicted
    flag there).
    """
    hkl = xp.asarray(hkl, dtype=d_matrix.dtype if hasattr(d_matrix, "dtype") else np.float64)
    S = setting_rotation
    F = fixed_rotation
    R = rotation_axis
    s0_ = xp.linalg.inv(S) @ s0
    m2 = R / xp.linalg.norm(R)
    s0_m2_plane = xp.cross(s0, S @ R)
    s0_m2_plane = s0_m2_plane / xp.linalg.norm(s0_m2_plane)

    m1 = xp.cross(m2, s0_)
    m1 = m1 / xp.linalg.norm(m1)
    m3 = xp.cross(m1, m2)
    m3 = m3 / xp.linalg.norm(m3)
    s0_d_m2 = s0_ @ m2
    s0_d_m3 = s0_ @ m3

    pstar0 = hkl @ (F @ ub).T
    pstar0_len_sq = xp.sum(pstar0**2, axis=1)
    valid = pstar0_len_sq <= 4 * (s0_ @ s0_)

    p_m1 = pstar0 @ m1
    p_m2 = pstar0 @ m2
    p_m3 = pstar0 @ m3
    pstar_d_m3 = (-(0.5 * pstar0_len_sq) - (p_m2 * s0_d_m2)) / s0_d_m3
    rho_sq = pstar0_len_sq - p_m2**2
    psq = pstar_d_m3**2
    valid = valid & (rho_sq >= psq)
    pstar_d_m1 = xp.sqrt(xp.maximum(rho_sq - psq, 0.0))

    p1 = pstar_d_m1 * p_m1
    p2 = pstar_d_m3 * p_m3
    p3 = pstar_d_m1 * p_m3
    p4 = pstar_d_m3 * p_m1

    def rotate(pstar0, angle):
        cosang = xp.cos(angle)[:, None]
        sinang = xp.sin(angle)[:, None]
        return (
            pstar0 * cosang
            + m2 * (pstar0 @ m2)[:, None] * (1.0 - cosang)
            + xp.cross(xp.broadcast_to(m2, pstar0.shape), pstar0) * sinang
        )

    a1 = xp.arctan2(p3 - p4, p1 + p2)
    a2 = xp.arctan2(-p3 - p4, -p1 + p2)

    s1_a1 = s0_ + rotate(pstar0, a1) @ S.T
    entering_a1 = (s1_a1 @ s0_m2_plane) < 0.0
    use_first = entering_a1 == xp.asarray(entering)

    angle = xp.where(use_first, _mod2pi(a1, xp), _mod2pi(a2, xp))
    s1_a2 = s0_ + rotate(pstar0, a2) @ S.T
    s1 = xp.where(use_first[:, None], s1_a1, s1_a2)

    # detector intersection: solve d_matrix @ (x, y, w) ~ s1
    v = s1 @ xp.linalg.inv(d_matrix).T
    w = v[:, 2]
    valid = valid & (w > 0)
    w_safe = xp.where(w == 0, 1.0, w)
    xmm = v[:, 0] / w_safe
    ymm = v[:, 1] / w_safe

    # fold the angle onto the observed turn (scan_static_predictor.cc:155-166)
    val = xp.mod(phi_obs, TWO_PI)
    resid = angle - val
    val2 = xp.mod(resid + np.pi, TWO_PI) - np.pi
    phical = phi_obs + val2

    xyzcal = xp.stack([xmm, ymm, phical], axis=1)
    return {"xyzcal_mm": xyzcal, "s1": s1, "valid": valid}


def d_matrix_from_panel(fast, slow, origin, xp=np):
    """Panel d-matrix: columns (fast, slow, origin) in mm."""
    return xp.stack([fast, slow, origin], axis=1)
