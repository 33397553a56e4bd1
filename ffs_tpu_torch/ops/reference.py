"""NumPy reference implementations of the spotfinding threshold algorithms.

These are the validation oracles (the equivalent of the reference's CPU
`StandaloneSpotfinder`, reference: baseline/spotfinder/standalone.cc:22-270,
used by `spotfinder --validate` at spotfinder/spotfinder.cc:1011-1053).  All
decision arithmetic follows the DIALS boxed-inequality formulation in IEEE
double precision:

    a = m*y - x*x - x*(m-1)        (variance test, cleared denominator)
    b = m*src - x                  (signal test, cleared denominator)
    c = x*nsig_b*sqrt(2*(m-1))
    d = nsig_s*sqrt(x*m)
    strong = a > c and b > d

where m/x/y are the masked count/sum/sum-of-squares over the local window.

The production GPU kernel in the reference evaluates the same predicates in
a mathematically equivalent mean/variance form (reference:
spotfinder/kernels/thresholding.cu:104-124); the boxed form here is exact in
integers up to the final sqrt comparisons, so it is the numerically safest
formulation and the one DIALS itself uses.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    DEFAULT_MIN_COUNT,
    DEFAULT_NSIG_B,
    DEFAULT_NSIG_S,
    EROSION_CHEBYSHEV_DISTANCE,
    KERNEL_RADIUS,
    KERNEL_RADIUS_EXTENDED,
)


def _window_sums(arr: np.ndarray, radius: int) -> np.ndarray:
    """Sum of ``arr`` over a (2r+1)^2 window, zero-padded at the borders."""
    h, w = arr.shape[-2:]
    pad = [(0, 0)] * (arr.ndim - 2) + [(radius, radius), (radius, radius)]
    p = np.pad(arr, pad)
    # Separable box filter via shifted adds (exact for integer dtypes)
    rows = np.zeros_like(p[..., radius : radius + h, :])
    for dy in range(2 * radius + 1):
        rows += p[..., dy : dy + h, :]
    out = np.zeros_like(rows[..., :, radius : radius + w])
    for dx in range(2 * radius + 1):
        out += rows[..., :, dx : dx + w]
    return out


def local_statistics(
    image: np.ndarray, mask: np.ndarray, radius: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Masked (count, sum, sum_sq) over the (2r+1)^2 local window.

    Matches the per-pixel neighbour accumulation of the reference kernel
    (reference: spotfinder/kernels/thresholding.cu:79-101): a neighbour
    contributes iff its mask value is non-zero; out-of-bounds neighbours are
    skipped (equivalent to zero padding).
    """
    valid = (mask != 0).astype(np.int64)
    img = image.astype(np.int64)
    m = _window_sums(valid, radius)
    x = _window_sums(np.where(valid != 0, img, 0), radius)
    y = _window_sums(np.where(valid != 0, img * img, 0), radius)
    return m, x, y


def dispersion(
    image: np.ndarray,
    mask: np.ndarray,
    trusted_max: float,
    *,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    nsig_s: float = DEFAULT_NSIG_S,
    radius: int = KERNEL_RADIUS,
) -> np.ndarray:
    """DIALS dispersion threshold (reference: thresholding.cu:145-234).

    Returns a boolean strong-pixel mask.
    """
    m, x, y = local_statistics(image, mask, radius)
    src = image.astype(np.float64)
    mf = m.astype(np.float64)
    xf = x.astype(np.float64)
    yf = y.astype(np.float64)

    a = mf * yf - xf * xf - xf * (mf - 1)
    b = mf * src - xf
    c = xf * nsig_b * np.sqrt(2 * (mf - 1))
    d = nsig_s * np.sqrt(xf * mf)

    px_valid = (mask != 0) & (src <= trusted_max)
    n_ok = (m >= min_count) & (m > 1)
    return px_valid & n_ok & (a > c) & (b > d)


def dispersion_extended_first_pass(
    image: np.ndarray,
    mask: np.ndarray,
    trusted_max: float,
    *,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    radius: int = KERNEL_RADIUS,
) -> np.ndarray:
    """Extended first pass: background (variance) test only
    (reference: thresholding.cu:253-342)."""
    m, x, y = local_statistics(image, mask, radius)
    src = image.astype(np.float64)
    mf = m.astype(np.float64)
    xf = x.astype(np.float64)
    yf = y.astype(np.float64)

    a = mf * yf - xf * xf - xf * (mf - 1)
    c = xf * nsig_b * np.sqrt(2 * (mf - 1))

    px_valid = (mask != 0) & (src <= trusted_max)
    n_ok = (m >= min_count) & (m > 1)
    return px_valid & n_ok & (a > c)


def erosion(
    dispersion_mask: np.ndarray,
    mask: np.ndarray,
    *,
    distance: int = EROSION_CHEBYSHEV_DISTANCE,
) -> np.ndarray:
    """Erode the first-pass dispersion mask (reference: erosion.cu:53-143).

    A candidate-signal pixel survives only if no valid-mask background pixel
    lies within Chebyshev distance ``distance``.  Returns the *survived
    signal* mask (True = signal).  Note the reference stores the inverse
    ("valid for background use"); callers derive that as ``~survived``.
    """
    background_nearby = _window_sums(
        ((mask != 0) & ~dispersion_mask).astype(np.int64), distance
    )
    return dispersion_mask & (background_nearby == 0)


def dispersion_extended_second_pass(
    image: np.ndarray,
    mask: np.ndarray,
    survived: np.ndarray,
    trusted_max: float,
    *,
    nsig_s: float = DEFAULT_NSIG_S,
    threshold: float = 0.0,
    radius: int = KERNEL_RADIUS_EXTENDED,
) -> np.ndarray:
    """Extended final pass (reference: thresholding.cu:360-491).

    Background statistics are taken over the 11x11 window excluding pixels
    that survived erosion; the centre pixel must itself have survived, exceed
    the global threshold, and exceed the local mean + nsig_s*sqrt(mean).
    """
    bg = (mask != 0) & ~survived
    n = _window_sums(bg.astype(np.int64), radius)
    x = _window_sums(np.where(bg, image.astype(np.int64), 0), radius)

    src = image.astype(np.float64)
    nf = n.astype(np.float64)
    xf = x.astype(np.float64)
    # mean = x/n for n > 1 else 0 (quirk preserved from thresholding.cu:482)
    mean = np.where(n > 1, xf / np.maximum(nf, 1), 0.0)
    local_ok = src >= mean + nsig_s * np.sqrt(mean)

    px_valid = (mask != 0) & (src <= trusted_max)
    return px_valid & (n > 0) & survived & (src > threshold) & local_ok


def dispersion_extended(
    image: np.ndarray,
    mask: np.ndarray,
    trusted_max: float,
    *,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    nsig_s: float = DEFAULT_NSIG_S,
) -> np.ndarray:
    """Full three-stage extended dispersion algorithm
    (reference: spotfinder/spotfinder.cu:213-347)."""
    first = dispersion_extended_first_pass(
        image, mask, trusted_max, min_count=min_count, nsig_b=nsig_b
    )
    survived = erosion(first, mask)
    return dispersion_extended_second_pass(
        image, mask, survived, trusted_max, nsig_s=nsig_s
    )
