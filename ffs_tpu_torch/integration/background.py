"""Constant background estimation over per-reflection histograms.

Equivalent of the reference's single-source host+device background models
(reference: include/integrator/background.hpp:78-465): the Tukey/IQR
outlier-rejecting constant model and the robust-Poisson GLM ("glm
constant3d", Parkhurst 2016) with Huber psi c = 1.345, IRLS on
beta = log(mu), exact Poisson pdf/cdf expectations.

Both models operate on bounded integer histograms (NUM_BG_BINS bins + a
high-tail overflow count), which makes them exact restatements of the
per-pixel DIALS computations and, on TPU, lets a whole reflection batch be
estimated as one vectorised program: every per-reflection scalar loop in
the reference becomes an (N, num_bins) reduction.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaln

NUM_BG_BINS = 256
MAX_OVERFLOW_FRACTION = 0.25
GLM_TUNING_CONSTANT = 1.345
GLM_TOLERANCE = 1e-3
GLM_MAX_ITER = 100
GLM_MIN_PIXELS = 10


def tukey_constant_background(
    bins: np.ndarray, overflow: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorised Tukey model over (N, num_bins) histograms.

    Returns (mean, weighted_sum, valid) per reflection
    (reference: background.hpp:135-217).
    """
    bins = np.asarray(bins, dtype=np.int64)
    overflow = np.asarray(overflow, dtype=np.int64)
    n, num_bins = bins.shape
    total = bins.sum(axis=1) + overflow
    valid = total > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        valid &= overflow <= MAX_OVERFLOW_FRACTION * total

    p25 = (total + 3) // 4
    p50 = (total + 1) // 2
    p75 = (3 * total + 1) // 4
    cum = np.cumsum(bins, axis=1)

    def quantile(p):
        # first bin v with cumulative >= p; num_bins if in the overflow tail
        hit = cum >= p[:, None]
        q = np.where(hit.any(axis=1), hit.argmax(axis=1), num_bins)
        return q

    q1 = quantile(p25)
    q3 = quantile(p75)
    iqr = (q3 - q1).astype(np.float64)
    lower = q1 - 1.5 * iqr
    upper = q3 + 1.5 * iqr
    valid &= upper < num_bins

    v = np.arange(num_bins)
    inlier = (v[None, :] >= lower[:, None]) & (v[None, :] <= upper[:, None])
    included = np.where(inlier, bins, 0)
    count = included.sum(axis=1)
    wsum = (included * v[None, :]).sum(axis=1).astype(np.float64)
    valid &= count > 0
    safe = np.where(count > 0, count, 1)
    mean = np.where(valid, wsum / safe, 0.0)
    return mean, np.where(valid, wsum, 0.0), valid


def dials_tukey_background(
    bins: np.ndarray, overflow: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Independent reimplementation of the reference's dials-faithful
    Tukey baseline (reference: src/integrator/background.cc:27-128,
    ``ConstantBackgroundImpl::DialsIndependent`` — the third selectable
    background impl, shipped precisely as a cross-check of the shared
    core, baseline/integrator/integrator.cc:112-116).

    Semantics of the dials-independent variant, reproduced here:

      * NO overflow-fraction rejection (the reference scans an unbounded
        histogram; there is no 25% tail cut);
      * NO blanket ``upper fence < num_bins`` rejection — high values can
        be genuine inliers.  Working from the bounded (bins, overflow)
        histogram this path rejects ONLY when the answer genuinely lives
        in the tail (a quartile or the upper fence reaches the >= num_bins
        range while tail pixels exist, where the true per-value counts
        are unknown) — for the realistic case (fences below num_bins) the
        result is exactly the reference's unbounded computation;
      * same 1-based quantile convention p25=(N+3)//4, p75=(3N+1)//4.

    Structure is deliberately a separate code path from
    :func:`tukey_constant_background`: quantiles by counting
    ``cum < p`` (not one-hot argmax) and inlier sums by cumulative-array
    differences (not masked reductions), so the two implementations can
    cross-check each other (tests/test_background_dials_golden.py).
    """
    bins = np.asarray(bins, dtype=np.int64)
    overflow = np.asarray(overflow, dtype=np.int64)
    n, num_bins = bins.shape
    total = bins.sum(axis=1) + overflow
    cum = np.cumsum(bins, axis=1)
    wcum = np.cumsum(bins * np.arange(num_bins)[None, :], axis=1)

    def quant(p):
        # number of values whose cumulative count stays below p = the
        # first value reaching p; num_bins when it lies in the tail
        return (cum < p[:, None]).sum(axis=1)

    q1 = quant((total + 3) // 4)
    q3 = quant((3 * total + 1) // 4)
    iqr = (q3 - q1).astype(np.float64)
    lower = q1 - 1.5 * iqr
    upper = q3 + 1.5 * iqr

    valid = total > 0
    # quartiles must be resolvable from the bounded histogram
    valid &= q1 < num_bins
    valid &= q3 < num_bins
    # the upper fence may only touch the tail when the tail is empty
    valid &= (upper < num_bins) | (overflow == 0)

    lo = np.clip(np.ceil(lower).astype(np.int64), 0, num_bins - 1)
    hi = np.clip(np.floor(upper).astype(np.int64), 0, num_bins - 1)
    rows = np.arange(n)
    count = cum[rows, hi] - np.where(lo > 0, cum[rows, np.maximum(lo - 1, 0)], 0)
    wsum = (
        wcum[rows, hi]
        - np.where(lo > 0, wcum[rows, np.maximum(lo - 1, 0)], 0)
    ).astype(np.float64)
    valid &= count > 0
    mean = np.where(valid, wsum / np.where(count > 0, count, 1), 0.0)
    return mean, np.where(valid, wsum, 0.0), valid


def _poisson_terms(mu: np.ndarray, kmax: int) -> np.ndarray:
    """P(Y = k) for k = 0..kmax-1 over a vector of means -> (N, kmax)."""
    k = np.arange(kmax)
    with np.errstate(divide="ignore", invalid="ignore"):
        logp = k[None, :] * np.log(np.maximum(mu[:, None], 1e-300)) - mu[
            :, None
        ] - gammaln(k + 1)[None, :]
    return np.exp(logp)


def glm_constant_background(
    bins: np.ndarray, overflow: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorised robust-Poisson GLM over (N, num_bins) histograms.

    Returns (mean, weighted_sum, valid) per reflection
    (reference: background.hpp:226-465)."""
    bins = np.asarray(bins, dtype=np.int64)
    overflow = np.asarray(overflow, dtype=np.int64)
    n, num_bins = bins.shape
    total = bins.sum(axis=1) + overflow
    alive = total >= GLM_MIN_PIXELS
    with np.errstate(divide="ignore", invalid="ignore"):
        alive &= overflow <= MAX_OVERFLOW_FRACTION * total

    # median seed (position total//2, 0-based)
    cum = np.cumsum(bins, axis=1)
    target = (total // 2 + 1)[:, None]
    hit = cum >= target
    median = np.where(hit.any(axis=1), hit.argmax(axis=1), -1).astype(np.float64)
    mean0 = np.where(median <= 0, 1.0, median)

    c = GLM_TUNING_CONSTANT
    beta = np.log(mean0)
    converged = np.zeros(n, dtype=bool)
    vgrid = np.arange(num_bins, dtype=np.float64)
    # pdf/cdf grid out to the largest index the expectations can reference
    kmax = num_bins + int(np.ceil(c * np.sqrt(num_bins))) + 8

    for _ in range(GLM_MAX_ITER):
        active = alive & ~converged
        if not active.any():
            break
        mu = np.exp(beta)
        dmu = mu
        svar = np.sqrt(mu)
        degenerate = ~((mu > 0) & (svar > 0) & np.isfinite(mu))
        alive &= ~degenerate

        terms = _poisson_terms(mu, kmax)  # (N, kmax)
        cdf_grid = np.cumsum(terms, axis=1)

        def pdf_at(j):
            jj = np.clip(j, -1, kmax - 1).astype(np.int64)
            out = np.take_along_axis(terms, np.maximum(jj, 0)[:, None], 1)[:, 0]
            return np.where(j < 0, 0.0, out)

        def cdf_at(j):
            jj = np.clip(j, -1, kmax - 1).astype(np.int64)
            out = np.take_along_axis(cdf_grid, np.maximum(jj, 0)[:, None], 1)[:, 0]
            return np.where(j < 0, 0.0, out)

        j1 = np.floor(mu - c * svar)
        j2 = np.floor(mu + c * svar)
        p1 = pdf_at(j1)
        p2 = pdf_at(j2)
        p3 = cdf_at(j1)
        p4 = pdf_at(j2 + 1)
        p5 = cdf_at(j2 + 1)
        p6 = 1.0 - p5 + p4
        p7 = pdf_at(j1 - 1)
        p8 = pdf_at(j2 - 1)
        p9 = cdf_at(j2 - 1)
        p10 = p9 - p3 + p1
        epsi1 = c * (p6 - p3) + (mu / svar) * (p1 - p2)
        epsi2 = c * (p1 + p2) + (mu**2 / svar**3) * (
            p10 / mu + p7 - p1 - p8 + p2
        )
        b = epsi2 * dmu * dmu / svar

        res = (vgrid[None, :] - mu[:, None]) / svar[:, None]
        psi = np.clip(res, -c, c)  # Huber
        q = (psi - epsi1[:, None]) * (dmu / svar)[:, None]
        U = (bins * q).sum(axis=1)
        U += overflow * (c - epsi1) * dmu / svar

        with np.errstate(divide="ignore", invalid="ignore"):
            delta = U / (total * b)
        delta = np.where(active & np.isfinite(delta), delta, 0.0)
        new_beta = beta + delta
        err = np.sqrt(delta**2 / np.maximum(beta**2, 1e-10))
        newly_converged = active & (err < GLM_TOLERANCE)
        beta = np.where(active, new_beta, beta)
        converged |= newly_converged

    valid = alive & converged & (beta > -300) & (beta < 300)
    mean = np.where(valid, np.exp(beta), 0.0)
    return mean, mean * total, valid


def estimate_background(
    bins: np.ndarray, overflow: np.ndarray, model: str = "tukey"
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    if model in ("tukey", "constant"):
        return tukey_constant_background(bins, overflow)
    if model == "dials":
        # the reference's third, INDEPENDENT Tukey implementation —
        # selectable as a cross-check of the shared core
        return dials_tukey_background(bins, overflow)
    if model == "glm":
        return glm_constant_background(bins, overflow)
    raise ValueError(f"unknown background model: {model}")
