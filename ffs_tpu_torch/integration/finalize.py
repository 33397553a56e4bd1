"""Summation-integration finalisation: intensities, variances, corrections.

Equivalent of the reference integrator's host finalisation (reference:
integrator/integrator.cc:1055-1329): I = sum(fg) - n_fg * b_mean,
Var(I) = |I| + |B| (1 + n_fg/n_bg), centroids from the foreground moments,
partiality from the erf of the bbox z-extent in units of sigma_m, the
Lorentz-polarisation factor (src/integrator/lp_correction.cc:12-39) and
d-spacings.

The host (NumPy) half is the port's copy of
:mod:`ffs_tpu.integration.finalize`; :func:`finalize_device` is the
``--bg-device`` form on a torch device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from scipy.special import erf

from ..utils.exact import dot3, norm3, quotient
from ..utils.torchinit import resolve_device
from .background import MAX_OVERFLOW_FRACTION, NUM_BG_BINS


@dataclass
class IntegrationResult:
    intensity: np.ndarray
    variance: np.ndarray
    background_mean: np.ndarray
    background_sum: np.ndarray
    xyzobs_px: np.ndarray
    partiality: np.ndarray
    lp: np.ndarray
    d: np.ndarray
    valid: np.ndarray
    n_background_failures: int


def check_overflow(bg_count: np.ndarray, bg_overflow: np.ndarray) -> None:
    """Hard error when the histogram range saturates
    (reference: integrator.cc:1067-1096)."""
    total = np.asarray(bg_count, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(total > 0, bg_overflow / np.maximum(total, 1), 0.0)
    overflowing = int((frac > MAX_OVERFLOW_FRACTION).sum())
    if overflowing:
        raise RuntimeError(
            f"{overflowing} reflection(s) put more than "
            f"{MAX_OVERFLOW_FRACTION * 100:.0f}% of their background pixels "
            f"above NUM_BG_BINS={NUM_BG_BINS}; the background histogram range "
            "is too small. Increase NUM_BG_BINS."
        )


def lorentz_polarization(
    s0: np.ndarray,
    m2: np.ndarray,
    s1: np.ndarray,
    polarization_normal=(0.0, 1.0, 0.0),
    polarization_fraction: float = 0.999,
) -> np.ndarray:
    """L/P factor per reflection (reference: lp_correction.cc:12-39)."""
    pn = np.asarray(polarization_normal, dtype=np.float64)
    s1_len = np.linalg.norm(s1, axis=1)
    s0_len = np.linalg.norm(s0)
    L = np.abs(s1 @ np.cross(m2, s0)) / (s0_len * s1_len)
    P1 = (s1 @ pn) / s1_len
    P2 = (1.0 - 2.0 * polarization_fraction) * (1.0 - P1 * P1)
    P3 = (s1 @ s0) / (s1_len * s0_len)
    P4 = polarization_fraction * (1.0 + P3 * P3)
    return L / (P2 + P4)


def finalize(
    *,
    acc,
    bg_mean: np.ndarray,
    bg_wsum: np.ndarray,
    bg_valid: np.ndarray,
    bboxes: np.ndarray,
    s1: np.ndarray,
    phi: np.ndarray,  # radians
    hkl: np.ndarray,
    zeta: np.ndarray,
    scan,
    beam,
    gonio,
    crystal,
    sigma_m: float,
) -> IntegrationResult:
    n = len(s1)
    fg_count = acc.fg_count
    bg_count = acc.bg_count
    measured = fg_count > 0
    b_mean = np.where(bg_valid, bg_mean, 0.0)

    background_total = b_mean * fg_count
    intensity = np.where(measured, acc.fg_sum - background_total, 0.0)
    ratio = np.where(bg_count > 0, fg_count / np.maximum(bg_count, 1), 0.0)
    variance = np.where(
        measured,
        np.abs(intensity) + np.abs(background_total) * (1.0 + ratio),
        -1.0,
    )
    n_bg_failures = int((measured & ~bg_valid).sum())

    # centroids: foreground moments, bbox centre fallback
    safe = np.where(acc.fg_sum > 0, acc.fg_sum, 1.0)
    com = np.stack(
        [acc.sum_ix / safe, acc.sum_iy / safe, acc.sum_iz / safe], axis=1
    )
    centre = np.stack(
        [
            0.5 * (bboxes[:, 0] + bboxes[:, 1]),
            0.5 * (bboxes[:, 2] + bboxes[:, 3]),
            0.5 * (bboxes[:, 4] + bboxes[:, 5]),
        ],
        axis=1,
    )
    xyzobs = np.where((acc.fg_sum > 0)[:, None], com, centre)

    # partiality (integrator.cc:1266-1277, replicated including its
    # degree-vs-radian unit convention)
    osc_start, osc_width = scan.oscillation
    z0 = scan.image_range[0]
    xyzcal_px_z = np.degrees(phi) / osc_width
    phi_deg = osc_start + (xyzcal_px_z + 1 - z0) * osc_width
    phia = osc_start + (bboxes[:, 4] + 1 - z0) * osc_width
    phib = osc_start + (bboxes[:, 5] + 1 - z0) * osc_width
    c = np.abs(zeta) / (np.sqrt(2.0) * sigma_m)
    partiality = 0.5 * (erf(c * (phib - phi_deg)) - erf(c * (phia - phi_deg)))

    lp = lorentz_polarization(
        beam.s0,
        gonio.rotation_axis,
        s1,
        polarization_normal=getattr(
            beam, "polarization_normal", (0.0, 1.0, 0.0)
        ),
        polarization_fraction=getattr(beam, "polarization_fraction", 0.999),
    )

    rlp = hkl @ crystal.a_matrix.T
    with np.errstate(divide="ignore"):
        d = 1.0 / np.linalg.norm(rlp, axis=1)

    return IntegrationResult(
        intensity=intensity,
        variance=variance,
        background_mean=b_mean,
        background_sum=np.where(bg_valid, bg_wsum, 0.0),
        xyzobs_px=xyzobs,
        partiality=partiality,
        lp=lp,
        d=d,
        # reference success_final: fg_count > 0 AND a valid background
        # estimate (integrator.cc:1245-1248) — a rejected background means
        # the intensity was never background-subtracted
        valid=measured & bg_valid & (variance >= 0),
        n_background_failures=n_bg_failures,
    )


def finalize_device(
    *,
    acc,
    bg_mean,
    bg_wsum,
    bg_valid,
    bboxes: np.ndarray,
    s1,
    phi,
    hkl: np.ndarray,
    zeta: np.ndarray,
    scan,
    beam,
    gonio,
    crystal,
    sigma_m: float,
    device=None,
) -> IntegrationResult:
    """:func:`finalize` as float64 tensor operations on ``device`` (by
    default the device of a tensor argument, e.g. the device background's
    results, else :func:`..utils.torchinit.select_device`); counterpart of
    the JAX package's fused device program.  Same fields, same
    ``n_background_failures`` and ``valid`` rule; the results come back to
    the host.  The 3-term products are index-order sums, divisions by a
    number are rounded once (:func:`..utils.exact.quotient`), and
    ``torch.special.erf`` stands for SciPy's erf (the two agree to float64
    rounding)."""
    dev = resolve_device(bg_mean, bg_wsum, bg_valid, s1, device=device)

    def t(x, dtype=torch.float64):
        return torch.as_tensor(x).to(dev, dtype)

    fg_sum, fg_count, bg_count = t(acc.fg_sum), t(acc.fg_count), t(acc.bg_count)
    sum_ix, sum_iy, sum_iz = t(acc.sum_ix), t(acc.sum_iy), t(acc.sum_iz)
    bg_valid = t(bg_valid, torch.bool)
    bb = t(bboxes)
    s1 = t(s1)

    measured = fg_count > 0
    b_mean = torch.where(bg_valid, t(bg_mean), 0.0)
    background_total = b_mean * fg_count
    intensity = torch.where(measured, fg_sum - background_total, 0.0)
    ratio = torch.where(bg_count > 0, fg_count / torch.clamp_min(bg_count, 1), 0.0)
    variance = torch.where(
        measured, torch.abs(intensity) + torch.abs(background_total) * (1.0 + ratio), -1.0
    )
    n_bg_failures = int((measured & ~bg_valid).sum())

    # centroids: foreground moments, bbox centre fallback
    safe = torch.where(fg_sum > 0, fg_sum, 1.0)
    com = torch.stack([sum_ix / safe, sum_iy / safe, sum_iz / safe], dim=1)
    centre = torch.stack(
        [0.5 * (bb[:, 0] + bb[:, 1]), 0.5 * (bb[:, 2] + bb[:, 3]), 0.5 * (bb[:, 4] + bb[:, 5])],
        dim=1,
    )
    xyzobs = torch.where((fg_sum > 0)[:, None], com, centre)

    # partiality (integrator.cc:1266-1277, degree/radian convention kept;
    # np.degrees multiplies by 180 / pi)
    osc_start, osc_width = scan.oscillation
    z0 = scan.image_range[0]
    xyzcal_px_z = quotient(t(phi) * (180.0 / math.pi), osc_width)
    phi_deg = osc_start + (xyzcal_px_z + 1 - z0) * osc_width
    phia = osc_start + (bb[:, 4] + 1 - z0) * osc_width
    phib = osc_start + (bb[:, 5] + 1 - z0) * osc_width
    c = quotient(torch.abs(t(zeta)), math.sqrt(2.0) * sigma_m)
    erf_t = torch.special.erf
    partiality = 0.5 * (erf_t(c * (phib - phi_deg)) - erf_t(c * (phia - phi_deg)))

    # L/P factor (lorentz_polarization above; lp_correction.cc:12-39)
    s0 = np.asarray(beam.s0, dtype=np.float64)
    pn = np.asarray(getattr(beam, "polarization_normal", (0.0, 1.0, 0.0)), dtype=np.float64)
    pol_frac = getattr(beam, "polarization_fraction", 0.999)
    s1_len = norm3(s1)
    s0_len = float(np.linalg.norm(s0))
    L = torch.abs(dot3(s1, np.cross(gonio.rotation_axis, s0))) / (s0_len * s1_len)
    P1 = dot3(s1, pn) / s1_len
    P2 = (1.0 - 2.0 * pol_frac) * (1.0 - P1 * P1)
    P3 = dot3(s1, s0) / (s1_len * s0_len)
    P4 = pol_frac * (1.0 + P3 * P3)
    lp = L / (P2 + P4)

    hkl_t = t(hkl)
    a_matrix = np.asarray(crystal.a_matrix, dtype=np.float64)
    rlp = torch.stack([dot3(hkl_t, a_matrix[j]) for j in range(3)], dim=1)
    d = quotient(1.0, norm3(rlp))

    def host(x):
        return x.cpu().numpy()

    return IntegrationResult(
        intensity=host(intensity),
        variance=host(variance),
        background_mean=host(b_mean),
        background_sum=host(torch.where(bg_valid, t(bg_wsum), 0.0)),
        xyzobs_px=host(xyzobs),
        partiality=host(partiality),
        lp=host(lp),
        d=host(d),
        valid=host(measured & bg_valid & (variance >= 0)),
        n_background_failures=n_bg_failures,
    )
