"""Kabsch bounding boxes and per-reflection coordinate systems.

Equivalent of the reference's extent computation (reference:
src/integrator/extent.cc:14-198) and CoordinateSystem
(src/integrator/coordinate_system.cc:10-34), fully vectorised.

The port's copy of the host (NumPy) half of :mod:`ffs_tpu.integration.extent`;
the device form of the bounding boxes (``--bg-device``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DEFAULT_N_SIGMA = 3.0
DEFAULT_SIGMA_B_MULTIPLIER = 2.0
ZETA_TOLERANCE = 1e-10


@dataclass
class CoordinateSystems:
    """Per-reflection Kabsch frames (vectorised)."""

    e1: np.ndarray  # (N, 3)
    e2: np.ndarray  # (N, 3)
    zeta: np.ndarray  # (N,)
    s1_len: np.ndarray  # (N,)


def coordinate_systems(s0: np.ndarray, m2: np.ndarray, s1: np.ndarray) -> CoordinateSystems:
    e1 = np.cross(s1, s0)
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(s1, e1)
    e2 /= np.linalg.norm(e2, axis=1, keepdims=True)
    return CoordinateSystems(
        e1=e1, e2=e2, zeta=e1 @ m2, s1_len=np.linalg.norm(s1, axis=1)
    )


def compute_kabsch_bounding_boxes(
    s0: np.ndarray,
    rot_axis: np.ndarray,
    s1: np.ndarray,
    phi: np.ndarray,  # (N,) radians (xyzcal.mm z column)
    sigma_b: float,
    sigma_m: float,
    panel,
    scan,
    n_sigma: float = DEFAULT_N_SIGMA,
    sigma_b_multiplier: float = DEFAULT_SIGMA_B_MULTIPLIER,
) -> np.ndarray:
    """Per-reflection (x_min, x_max, y_min, y_max, z_min, z_max) int array.

    delta_b = n_sigma*sigma_b*multiplier spans e1/e2; the four corner
    displacements are re-projected onto the Ewald sphere and ray-intersected
    with the panel; delta_m/zeta spans phi (extent.cc:47-192).
    """
    n = len(s1)
    cs = coordinate_systems(s0, rot_axis, s1)
    delta_b = n_sigma * sigma_b * sigma_b_multiplier
    delta_m = n_sigma * sigma_m

    osc_start, osc_width = scan.oscillation
    z0, z1 = scan.image_range

    s1_len = cs.s1_len[:, None]
    corners_xy = []
    for e1_sign, e2_sign in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        p = (
            e1_sign * delta_b * cs.e1 * s1_len
            + e2_sign * delta_b * cs.e2 * s1_len
        )
        b = cs.s1_len**2 - np.sum(p * p, axis=1)
        b = np.maximum(b, 0.0)  # degenerate: displacement beyond the sphere
        d = -(np.sum(p * s1, axis=1) / cs.s1_len) + np.sqrt(b)
        s_prime = d[:, None] * s1 / s1_len + p
        xmm, ymm = panel.get_ray_intersection(s_prime)
        x_px, y_px = panel.mm_to_px(xmm, ymm)
        corners_xy.append((x_px, y_px))

    xs = np.stack([c[0] for c in corners_xy])
    ys = np.stack([c[1] for c in corners_xy])
    x_min = np.floor(xs.min(axis=0)).astype(np.int64)
    x_max = np.ceil(xs.max(axis=0)).astype(np.int64)
    y_min = np.floor(ys.min(axis=0)).astype(np.int64)
    y_max = np.ceil(ys.max(axis=0)).astype(np.int64)

    # z extent from phi_c +- delta_m / zeta (extent.cc:157-192)
    with np.errstate(divide="ignore", invalid="ignore"):
        dphi = delta_m / cs.zeta
    phi_plus = np.degrees(phi + dphi)
    phi_minus = np.degrees(phi - dphi)
    zp = z0 - 1 + (phi_plus - osc_start) / osc_width
    zm = z0 - 1 + (phi_minus - osc_start) / osc_width
    z_min = np.clip(np.floor(np.minimum(zp, zm)), z0 - 1, z1 - 1).astype(np.int64)
    z_max = np.clip(np.ceil(np.maximum(zp, zm)), z0, z1).astype(np.int64)
    degenerate = np.abs(cs.zeta) <= ZETA_TOLERANCE
    z_min = np.where(degenerate, z0, z_min)
    z_max = np.where(degenerate, z1, z_max)

    return np.stack([x_min, x_max, y_min, y_max, z_min, z_max], axis=1)
