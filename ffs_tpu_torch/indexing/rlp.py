"""Map detector centroids to reciprocal-lattice points.

Equivalent of the reference's xyz_to_rlp (reference:
baseline/indexer/xyz_to_rlp.cc:46-150), following the DIALS conventions:
rlp = F^-1 * R(-phi) * S^-1 * (s1 - s0).  Vectorised over reflections; the
JAX variant is used inside batched candidate scoring.
"""

from __future__ import annotations

import numpy as np


def xyz_to_rlp(
    xyzobs_px: np.ndarray,
    panel,
    beam,
    scan,
    gonio,
) -> dict:
    """Returns dict with 'rlp', 's1' (N, 3) and 'xyzobs_mm' (N, 3)."""
    xyz = np.asarray(xyzobs_px, dtype=np.float64)
    s0 = beam.s0
    wl = beam.wavelength
    osc_start, osc_width = scan.oscillation
    image_range_start = scan.image_range[0]
    setting_inv = np.linalg.inv(gonio.setting_rotation)
    sample_inv = np.linalg.inv(gonio.fixed_rotation)
    axis = np.asarray(gonio.rotation_axis, dtype=np.float64)

    xmm, ymm = panel.px_to_mm(xyz[:, 0], xyz[:, 1])
    # image 'z' -> rotation angle (x3 is 0-based here, +1 converts to the
    # 1-based frame convention used by the reference, xyz_to_rlp.cc:75-77)
    rot_angle = np.deg2rad(
        (xyz[:, 2] + 1 - image_range_start) * osc_width + osc_start
    )

    lab = panel.get_lab_coord(xmm, ymm)
    s1 = lab / np.linalg.norm(lab, axis=-1, keepdims=True) / wl

    S = (s1 - s0) @ setting_inv.T
    cos = np.cos(-rot_angle)[:, None]
    sin = np.sin(-rot_angle)[:, None]
    ax_dot = (S @ axis)[:, None]
    rlp = S * cos + axis * ax_dot * (1 - cos) + sin * np.cross(
        np.broadcast_to(axis, S.shape), S
    )
    rlp = rlp @ sample_inv.T
    return {
        "rlp": rlp,
        "s1": s1,
        "xyzobs_mm": np.stack([xmm, ymm, rot_angle], axis=1),
    }


def ssx_xyz_to_rlp(xyzobs_px: np.ndarray, panel, wavelength: float) -> np.ndarray:
    """Stills version: rlp = s1/|s1|/wl - s0 with s0 along -z
    (reference: xyz_to_rlp.cc:119-150, exported to Python via
    index_module.cpp ssx_xyz_to_rlp)."""
    xyz = np.asarray(xyzobs_px, dtype=np.float64)
    xmm, ymm = panel.px_to_mm(xyz[:, 0], xyz[:, 1])
    lab = panel.get_lab_coord(xmm, ymm)
    s1 = lab / np.linalg.norm(lab, axis=-1, keepdims=True) / wavelength
    s0 = np.array([0.0, 0.0, -1.0 / wavelength])
    return s1 - s0
