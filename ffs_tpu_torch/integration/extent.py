"""Kabsch bounding boxes and per-reflection coordinate systems.

Equivalent of the reference's extent computation (reference:
src/integrator/extent.cc:14-198) and CoordinateSystem
(src/integrator/coordinate_system.cc:10-34), fully vectorised.

The host (NumPy) half is the port's copy of :mod:`ffs_tpu.integration.extent`;
:func:`compute_kabsch_bounding_boxes_device` is the ``--bg-device`` form on a
torch device.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.exact import cross3, dot3, norm3, quotient, sum3
from ..utils.torchinit import resolve_device

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


def compute_kabsch_bounding_boxes_device(
    s0: np.ndarray,
    rot_axis: np.ndarray,
    s1,
    phi,
    sigma_b: float,
    sigma_m: float,
    panel,
    scan,
    n_sigma: float = DEFAULT_N_SIGMA,
    sigma_b_multiplier: float = DEFAULT_SIGMA_B_MULTIPLIER,
    device=None,
) -> np.ndarray:
    """:func:`compute_kabsch_bounding_boxes` as float64 tensor operations
    on ``device`` (by default the device of a tensor ``s1``, else
    :func:`..utils.torchinit.select_device`); counterpart of the JAX
    package's fused device program.

    Bit-equal to the host's: every 3-term product and norm is an explicit
    index-order sum, every division by or of a number is rounded once
    (:func:`..utils.exact.quotient`), and the corner and z extents take NumPy's operation
    order.  The float64 extents come back to the host and are cast there,
    so that a row whose ray misses the panel plane (NaN) becomes int64 min
    as on the host path; a NaN cast on the card would not."""
    dev = resolve_device(s1, phi, device=device)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64).to(dev)

    s1 = t(s1)
    phi = t(phi)
    s0_t = t(s0)
    delta_b = n_sigma * sigma_b * sigma_b_multiplier
    delta_m = n_sigma * sigma_m
    osc_start, osc_width = scan.oscillation
    z0, z1 = scan.image_range
    d_mat = np.stack([panel.fast_axis, panel.slow_axis, panel.origin], axis=1)
    dinv = np.linalg.inv(d_mat)  # v = s' @ dinv.T: v_j = s' . dinv[j]
    px0, px1 = panel.pixel_size

    # coordinate systems (coordinate_systems above); rot_axis raw, as the
    # host path takes it
    e1 = cross3(s1, s0_t)
    e1 = e1 / norm3(e1)[:, None]
    e2 = cross3(s1, e1)
    e2 = e2 / norm3(e2)[:, None]
    zeta = dot3(e1, rot_axis)
    s1_len = norm3(s1)
    sl = s1_len[:, None]

    origin, fast, slow = (t(a) for a in (panel.origin, panel.fast_axis, panel.slow_axis))

    def mm_to_px(xmm, ymm):
        if not panel.parallax:
            return quotient(xmm, px0), quotient(ymm, px1)
        lab = origin + xmm[:, None] * fast + ymm[:, None] * slow
        sh = lab / norm3(lab)[:, None]
        # Panel.attenuation_length
        cos_t = dot3(sh, panel.normal)
        mu, thickness = panel.mu, panel.thickness
        o = (1.0 / mu) - (quotient(thickness, cos_t) + 1.0 / mu) * torch.exp(
            quotient(-mu * thickness, cos_t)
        )
        return (
            quotient(xmm + dot3(sh, panel.fast_axis) * o, px0),
            quotient(ymm + dot3(sh, panel.slow_axis) * o, px1),
        )

    xs, ys = [], []
    for e1_sign, e2_sign in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        p = e1_sign * delta_b * e1 * sl + e2_sign * delta_b * e2 * sl
        b = torch.clamp_min(s1_len**2 - sum3(p * p), 0.0)
        d = -(sum3(p * s1) / s1_len) + torch.sqrt(b)
        s_prime = d[:, None] * s1 / sl + p
        v = [dot3(s_prime, dinv[j]) for j in range(3)]  # Panel.get_ray_intersection
        x_px, y_px = mm_to_px(v[0] / v[2], v[1] / v[2])
        xs.append(x_px)
        ys.append(y_px)
    # minimum/maximum propagate NaN, as NumPy's min/max reductions do
    x_lo, x_hi = functools.reduce(torch.minimum, xs), functools.reduce(torch.maximum, xs)
    y_lo, y_hi = functools.reduce(torch.minimum, ys), functools.reduce(torch.maximum, ys)

    # z extent from phi_c +- delta_m / zeta (extent.cc:157-192); np.degrees
    # multiplies by 180 / pi
    dphi = quotient(delta_m, zeta)
    phi_plus = (phi + dphi) * (180.0 / math.pi)
    phi_minus = (phi - dphi) * (180.0 / math.pi)
    zp = (z0 - 1) + quotient(phi_plus - osc_start, osc_width)
    zm = (z0 - 1) + quotient(phi_minus - osc_start, osc_width)
    z_min = torch.clamp(torch.floor(torch.minimum(zp, zm)), z0 - 1, z1 - 1)
    z_max = torch.clamp(torch.ceil(torch.maximum(zp, zm)), z0, z1)
    degenerate = torch.abs(zeta) <= ZETA_TOLERANCE
    z_min = torch.where(degenerate, float(z0), z_min)
    z_max = torch.where(degenerate, float(z1), z_max)

    out = torch.stack(
        [torch.floor(x_lo), torch.ceil(x_hi), torch.floor(y_lo), torch.ceil(y_hi), z_min, z_max],
        dim=1,
    )
    with np.errstate(invalid="ignore"):
        return out.cpu().numpy().astype(np.int64)
