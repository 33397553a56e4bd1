"""Constant background estimation on a torch device (``--bg-device``).

Counterpart of :mod:`ffs_tpu.integration.background_jax` (reference GPU
reduction: integrator/background.cu:29-99, dispatching the single-source
models of include/integrator/background.hpp:78-465): a whole reflection
batch is estimated as (N, num_bins) tensor operations, the Tukey/IQR model
as vectorised reductions, the robust-Poisson GLM as the IRLS update looped
with a per-reflection convergence mask.

Numerics follow :mod:`.background` (the NumPy functions) at 1e-12 in
float64: ``exp``, ``log`` and ``lgamma`` on the card may differ from the
host's by an ulp or so; the valid masks are exact.
"""

from __future__ import annotations

import math

import torch

from ..utils.torchinit import resolve_device
from .background import (
    GLM_MAX_ITER,
    GLM_MIN_PIXELS,
    GLM_TOLERANCE,
    GLM_TUNING_CONSTANT,
    MAX_OVERFLOW_FRACTION,
)

# rows of one pass of either model: bounds the (rows, kmax) float64 GLM
# intermediates (~0.6 GB each at kmax = 286) and the (rows, num_bins)
# Tukey planes at collection scale
ROW_BLOCK = 1 << 18


def _first_hit(hit: torch.Tensor, none: int) -> torch.Tensor:
    """Index of the first True of each row of ``hit``; ``none`` where no
    element is True."""
    first = torch.argmax(hit.to(torch.uint8), dim=1)
    return torch.where(hit.any(dim=1), first, none)


def _by_row_blocks(rows_fn, bins: torch.Tensor, overflow: torch.Tensor, dtype):
    """``rows_fn`` over blocks of :data:`ROW_BLOCK` rows, concatenated."""
    block = ROW_BLOCK
    parts = [
        rows_fn(bins[r0 : r0 + block], overflow[r0 : r0 + block], dtype)
        for r0 in range(0, max(len(bins), 1), block)
    ]
    return tuple(torch.cat(p) for p in zip(*parts))


def tukey_constant_background_device(
    bins: torch.Tensor, overflow: torch.Tensor, dtype=torch.float64
):
    """Vectorised Tukey model (reference: background.hpp:135-217).

    ``bins`` (N, num_bins) integer histograms, ``overflow`` (N,) high-tail
    counts, on one device -> (mean, weighted_sum, valid), all (N,).  Rows
    are independent, so the blocks of :data:`ROW_BLOCK` rows give the
    one-pass results.
    """
    return _by_row_blocks(_tukey_rows, bins, overflow, dtype)


def _tukey_rows(bins: torch.Tensor, overflow: torch.Tensor, dtype):
    """The Tukey model over one block of rows."""
    num_bins = bins.shape[1]
    total = bins.sum(dim=1) + overflow
    valid = total > 0
    valid &= overflow.to(dtype) <= MAX_OVERFLOW_FRACTION * total.to(dtype)

    p25 = (total + 3) // 4
    p75 = (3 * total + 1) // 4
    cum = torch.cumsum(bins, dim=1)
    q1 = _first_hit(cum >= p25[:, None], num_bins)
    q3 = _first_hit(cum >= p75[:, None], num_bins)
    del cum
    iqr = (q3 - q1).to(dtype)
    lower = q1.to(dtype) - 1.5 * iqr
    upper = q3.to(dtype) + 1.5 * iqr
    valid &= upper < num_bins

    v = torch.arange(num_bins, dtype=dtype, device=bins.device)
    inlier = (v[None, :] >= lower[:, None]) & (v[None, :] <= upper[:, None])
    included = torch.where(inlier, bins, 0)
    count = included.sum(dim=1)
    wsum = (included.to(dtype) * v[None, :]).sum(dim=1)
    valid &= count > 0
    safe = torch.where(count > 0, count, 1).to(dtype)
    mean = torch.where(valid, wsum / safe, 0.0)
    return mean, torch.where(valid, wsum, 0.0), valid


def _glm_rows(bins: torch.Tensor, overflow: torch.Tensor, dtype):
    """The GLM over one block of rows, with the JAX loop's stopping rule:
    iterate while any row is alive and unconverged, at most GLM_MAX_ITER
    times (one host check per iteration)."""
    dev = bins.device
    n, num_bins = bins.shape
    total = bins.sum(dim=1) + overflow
    alive = total >= GLM_MIN_PIXELS
    alive &= overflow.to(dtype) <= MAX_OVERFLOW_FRACTION * total.to(dtype)

    target = (total // 2 + 1)[:, None]
    median = _first_hit(torch.cumsum(bins, dim=1) >= target, -1).to(dtype)
    mean0 = torch.where(median <= 0, 1.0, median)

    c = GLM_TUNING_CONSTANT
    vgrid = torch.arange(num_bins, dtype=dtype, device=dev)
    kmax = num_bins + int(math.ceil(c * math.sqrt(num_bins))) + 8
    kgrid = torch.arange(kmax, dtype=dtype, device=dev)
    lgamma_k1 = torch.lgamma(kgrid + 1.0)
    totf = total.to(dtype)
    binsf = bins.to(dtype)
    overf = overflow.to(dtype)

    beta = torch.log(mean0)
    converged = torch.zeros(n, dtype=torch.bool, device=dev)
    it = 0
    while it < GLM_MAX_ITER and bool((alive & ~converged).any()):
        active = alive & ~converged
        mu = torch.exp(beta)
        dmu = mu
        svar = torch.sqrt(mu)
        degenerate = ~((mu > 0) & (svar > 0) & torch.isfinite(mu))
        alive = alive & ~degenerate

        logmu = torch.log(torch.clamp_min(mu, 1e-300))
        # P(Y = k) for k < kmax and its running sum, built in place
        terms = kgrid[None, :] * logmu[:, None]
        terms.sub_(mu[:, None]).sub_(lgamma_k1[None, :]).exp_()
        cdf_grid = torch.cumsum(terms, dim=1)

        def at(grid, j):
            # the grid's value at index j (clipped to kmax - 1), 0 for j < 0;
            # the index is clamped again after the cast so that a NaN j
            # (a degenerate row, whose result is masked) stays in range
            jj = torch.clamp(j, -1, kmax - 1).to(torch.int64).clamp_(0, kmax - 1)
            out = torch.gather(grid, 1, jj[:, None])[:, 0]
            return torch.where(j < 0, 0.0, out)

        j1 = torch.floor(mu - c * svar)
        j2 = torch.floor(mu + c * svar)
        p1 = at(terms, j1)
        p2 = at(terms, j2)
        p3 = at(cdf_grid, j1)
        p4 = at(terms, j2 + 1)
        p5 = at(cdf_grid, j2 + 1)
        p6 = 1.0 - p5 + p4
        p7 = at(terms, j1 - 1)
        p8 = at(terms, j2 - 1)
        p9 = at(cdf_grid, j2 - 1)
        del terms, cdf_grid
        p10 = p9 - p3 + p1
        epsi1 = c * (p6 - p3) + (mu / svar) * (p1 - p2)
        epsi2 = c * (p1 + p2) + (mu**2 / svar**3) * (p10 / mu + p7 - p1 - p8 + p2)
        b = epsi2 * dmu * dmu / svar

        # Huber psi of the residuals, weighted by the histogram
        q = (vgrid[None, :] - mu[:, None]) / svar[:, None]
        q.clamp_(-c, c).sub_(epsi1[:, None]).mul_((dmu / svar)[:, None])
        u = (binsf * q).sum(dim=1)
        del q
        u = u + overf * (c - epsi1) * dmu / svar

        denom = totf * b
        ratio = u / torch.where(denom == 0, 1.0, denom)
        delta = torch.where(active & torch.isfinite(ratio) & (denom != 0), ratio, 0.0)
        new_beta = beta + delta
        err = torch.sqrt(delta**2 / torch.clamp_min(beta**2, 1e-10))
        newly = active & (err < GLM_TOLERANCE)
        beta = torch.where(active, new_beta, beta)
        converged = converged | newly
        it += 1

    valid = alive & converged & (beta > -300) & (beta < 300)
    mean = torch.where(valid, torch.exp(beta), 0.0)
    return mean, mean * totf, valid


def glm_constant_background_device(
    bins: torch.Tensor, overflow: torch.Tensor, dtype=torch.float64
):
    """Vectorised robust-Poisson GLM (reference: background.hpp:226-465).

    IRLS on beta = log(mu) with Huber psi (c = 1.345) and exact Poisson
    pdf/cdf expectations, over blocks of :data:`ROW_BLOCK` rows.  Rows are
    independent: a converged row keeps its beta, and the only state the
    JAX loop goes on deriving for it after convergence, ``alive``, turns
    false only where exp(beta) is 0, inf or NaN, which the final
    (-300, 300) range test already rejects.  So a block stopping when its
    own rows are done gives the unblocked loop's results
    (tests/test_torch_bg_device.py holds it).
    """
    return _by_row_blocks(_glm_rows, bins, overflow, dtype)


def estimate_background_device(
    bins, overflow, model: str = "tukey", dtype=torch.float64, device=None
):
    """Device dispatcher mirroring :func:`.background.estimate_background`.

    ``bins`` and ``overflow`` are NumPy arrays or tensors; they go to
    ``device`` (by default the device of a tensor argument, else
    :func:`..utils.torchinit.select_device`).  Returns (mean, weighted_sum,
    valid) as tensors on that device."""
    if model in ("tukey", "constant", "dials"):
        fn = tukey_constant_background_device
    elif model == "glm":
        fn = glm_constant_background_device
    else:
        raise ValueError(f"unknown background model: {model}")
    dev = resolve_device(bins, overflow, device=device)
    return fn(
        torch.as_tensor(bins).to(dev, torch.int64),
        torch.as_tensor(overflow).to(dev, torch.int64),
        dtype=dtype,
    )
