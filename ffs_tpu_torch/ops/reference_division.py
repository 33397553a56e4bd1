"""Independent spotfinding oracle in the reference GPU kernel's own form.

A second NumPy implementation of the dispersion predicates, written in the
*literal* mean/variance division form the reference CUDA kernel evaluates in
float32 (reference: spotfinder/kernels/thresholding.cu:104-124):

    mean       = sum / n                       (f32)
    variance   = (n*sumsq - sum*sum) / (n*(n-1))   (f32)
    dispersion = variance / mean               (f32)
    background: dispersion > 1 + n_sig_b * sqrt(2/(n-1))
    signal:     pixel > mean + n_sig_s * sqrt(mean)

This is deliberately NOT derived from :mod:`.reference` (which
uses the DIALS boxed-inequality form in f64) — the two implementations share
only the window-sum definition, so a derivation bug in the boxed form (e.g.
a boundary-tie behaviour difference vs the division) cannot hide in both.
``tests/test_oracle_cross_form.py`` fuzzes the two against each other on
adversarial near-tie frames and pins down exactly when they may disagree:
only where the f32-rounded division form lands within a few ulps of the
predicate boundary.

Algebraic identity (exact arithmetic): with m/x/y the masked window
count/sum/sum-of-squares,

    variance/mean > 1 + nsig_b*sqrt(2/(m-1))
        <=> m*y - x*x - x*(m-1) > x*nsig_b*sqrt(2*(m-1))     [a > c]
    pixel > mean + nsig_s*sqrt(mean)
        <=> m*pixel - x > nsig_s*sqrt(x*m)                   [b > d]

so any disagreement is purely floating-point.

The port's copy of :mod:`ffs_tpu.ops.reference_division` (NumPy only, so
copied, not ported): ``chip_smoke.py`` holds the card's float32 threshold
kernel against it.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    DEFAULT_MIN_COUNT,
    DEFAULT_NSIG_B,
    DEFAULT_NSIG_S,
    KERNEL_RADIUS,
    KERNEL_RADIUS_EXTENDED,
)
from .reference import _window_sums, erosion, local_statistics

f32 = np.float32


def dispersion_division_f32(
    image: np.ndarray,
    mask: np.ndarray,
    trusted_max: float,
    *,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    nsig_s: float = DEFAULT_NSIG_S,
    radius: int = KERNEL_RADIUS,
) -> np.ndarray:
    """Strong-pixel mask via the f32 mean/variance division predicates
    (reference: thresholding.cu:104-124, kernel `dispersion` :145-234)."""
    m, x, y = local_statistics(image, mask, radius)
    n = m.astype(np.int64)
    sum_f = x.astype(f32)
    sumsq_f = y.astype(f32)
    nf = n.astype(f32)

    with np.errstate(divide="ignore", invalid="ignore"):
        mean = sum_f / nf
        variance = (nf * sumsq_f - sum_f * sum_f) / (nf * (nf - f32(1.0)))
        dispersion = variance / mean
        background_threshold = f32(1.0) + f32(nsig_b) * np.sqrt(
            f32(2.0) / (nf - f32(1.0))
        )
        signal_threshold = mean + f32(nsig_s) * np.sqrt(mean)

    not_background = dispersion > background_threshold
    # the GPU compares the raw pixel value (pixel_t) promoted to f32
    is_signal = image.astype(f32) > signal_threshold

    px_valid = (mask != 0) & (image.astype(np.float64) <= trusted_max)
    n_ok = n >= min_count
    return px_valid & n_ok & not_background & is_signal


def dispersion_extended_first_pass_division_f32(
    image: np.ndarray,
    mask: np.ndarray,
    trusted_max: float,
    *,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    radius: int = KERNEL_RADIUS,
) -> np.ndarray:
    """Extended first pass (background test only) in division form
    (reference: thresholding.cu:253-342)."""
    m, x, y = local_statistics(image, mask, radius)
    n = m.astype(np.int64)
    sum_f = x.astype(f32)
    sumsq_f = y.astype(f32)
    nf = n.astype(f32)

    with np.errstate(divide="ignore", invalid="ignore"):
        mean = sum_f / nf
        variance = (nf * sumsq_f - sum_f * sum_f) / (nf * (nf - f32(1.0)))
        dispersion = variance / mean
        background_threshold = f32(1.0) + f32(nsig_b) * np.sqrt(
            f32(2.0) / (nf - f32(1.0))
        )

    px_valid = (mask != 0) & (image.astype(np.float64) <= trusted_max)
    return px_valid & (n >= min_count) & (dispersion > background_threshold)


def dispersion_extended_second_pass_division_f32(
    image: np.ndarray,
    mask: np.ndarray,
    survived: np.ndarray,
    trusted_max: float,
    *,
    nsig_s: float = DEFAULT_NSIG_S,
    threshold: float = 0.0,
    radius: int = KERNEL_RADIUS_EXTENDED,
) -> np.ndarray:
    """Extended final pass in f32 division form
    (reference: thresholding.cu:360-491)."""
    bg = (mask != 0) & ~survived
    n = _window_sums(bg.astype(np.int64), radius)
    x = _window_sums(np.where(bg, image.astype(np.int64), 0), radius)

    nf = n.astype(f32)
    sum_f = x.astype(f32)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = np.where(n > 1, sum_f / np.maximum(nf, f32(1.0)), f32(0.0))
        local_ok = image.astype(f32) >= mean + f32(nsig_s) * np.sqrt(mean)

    px_valid = (mask != 0) & (image.astype(np.float64) <= trusted_max)
    return (
        px_valid
        & (n > 0)
        & survived
        & (image.astype(np.float64) > threshold)
        & local_ok
    )


def dispersion_extended_division_f32(
    image: np.ndarray,
    mask: np.ndarray,
    trusted_max: float,
    *,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    nsig_s: float = DEFAULT_NSIG_S,
) -> np.ndarray:
    """Full three-stage extended algorithm, division-form predicates
    (reference: spotfinder/spotfinder.cu:213-347)."""
    first = dispersion_extended_first_pass_division_f32(
        image, mask, trusted_max, min_count=min_count, nsig_b=nsig_b
    )
    survived = erosion(first, mask)
    return dispersion_extended_second_pass_division_f32(
        image, mask, survived, trusted_max, nsig_s=nsig_s
    )
