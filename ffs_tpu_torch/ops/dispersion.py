"""Dispersion-threshold ops in plain PyTorch.

Counterpart of :mod:`ffs_tpu.ops.dispersion`: the DIALS dispersion and
dispersion-extended thresholds in the boxed-inequality form (derivation in
ffs_tpu/ops/reference.py), computed as separable shifted adds over whole
frames.  float64 gives bit-parity with the DIALS CPU implementation and is
the CLI default; float32 is the arithmetic the CUDA kernels
(ops/dispersion_packed.py, ops/dispersion_extended_packed.py) reproduce bit
for bit, so these functions are also their oracle.

Every function takes tensors shaped (..., H, W) on any device; leading batch
dimensions are carried through.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..constants import (
    DEFAULT_MIN_COUNT,
    DEFAULT_NSIG_B,
    DEFAULT_NSIG_S,
    DEFAULT_THRESHOLD,
    EROSION_CHEBYSHEV_DISTANCE,
    KERNEL_RADIUS,
    KERNEL_RADIUS_EXTENDED,
)


def _pow2_parts(k: int) -> list[int]:
    """Descending power-of-two decomposition of ``k`` (7 -> [4, 2, 1])."""
    parts, p = [], 1
    while 2 * p <= k:
        p *= 2
    while k:
        if p <= k:
            parts.append(p)
            k -= p
        p //= 2
    return parts


def _tree_window_axis(p: torch.Tensor, k: int, n: int, dim: int) -> torch.Tensor:
    """k-wide sliding sums along ``dim`` in the canonical shared-subsum tree
    order: s2[i] = s1[i] + s1[i+1], s4[i] = s2[i] + s2[i+2], ..., then the
    power-of-two parts of k combined left to right, e.g. for k == 7

        W[i] = (s4[i] + s2[i+4]) + s1[i+6]

    This association order is the float contract shared with
    ffs_tpu.ops.dispersion._tree_window_axis and the CUDA kernels; the
    rounding-sensitive sum-of-squares grid depends on it.
    """
    parts = _pow2_parts(k)
    levels = {1: p}
    sz = 1
    while sz < parts[0]:
        prev = levels[sz]
        ln = prev.shape[dim] - sz
        levels[2 * sz] = prev.narrow(dim, 0, ln) + prev.narrow(dim, sz, ln)
        sz *= 2
    acc = None
    off = 0
    for part in parts:
        t = levels[part].narrow(dim, off, n)
        acc = t if acc is None else acc + t
        off += part
    return acc


def box_sum(arr: torch.Tensor, radius: int) -> torch.Tensor:
    """Sum over a (2r+1)^2 window with zero padding: vertical sums first,
    then horizontal, each in the canonical tree order."""
    k = 2 * radius + 1
    h, w = arr.shape[-2], arr.shape[-1]
    rows = _tree_window_axis(F.pad(arr, (0, 0, radius, radius)), k, h, arr.dim() - 2)
    return _tree_window_axis(F.pad(rows, (radius, radius)), k, w, arr.dim() - 1)


def _scalar(v: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-d tensor of ``dtype``: comparisons and products then round the
    Python constant to the compute dtype first, as the jnp code does."""
    return torch.tensor(v, dtype=dtype, device=device)


def widen_pixels(image: torch.Tensor) -> torch.Tensor:
    """Unsigned 16/32-bit pixels -> int32/int64 holding the same values.

    Goes through same-width signed views: PyTorch supports few operations
    on its unsigned 16- and 32-bit dtypes, on CUDA especially.  Converting
    the int64 form of a u32 pixel to float32 rounds to nearest, exactly like
    the jnp ``astype``, saturation sentinels included.
    """
    if image.dtype == torch.uint16:
        return image.view(torch.int16).to(torch.int32) & 0xFFFF
    if image.dtype == torch.uint32:
        return image.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return image


def _local_stats(image, mask_valid, radius, dtype):
    """Masked (count, sum, sum_sq) over the local window, in ``dtype``."""
    img = widen_pixels(image).to(dtype)
    zero = torch.zeros((), dtype=dtype, device=img.device)
    m = box_sum(mask_valid.to(dtype), radius)
    x = box_sum(torch.where(mask_valid, img, zero), radius)
    y = box_sum(torch.where(mask_valid, img * img, zero), radius)
    return m, x, y


def _background_test(image, mask, trusted_max, min_count, nsig_b, dtype):
    """Shared first stage over the r=3 window: (src, m, x, background
    variance predicate)."""
    mask_valid = mask != 0
    m, x, y = _local_stats(image, mask_valid, KERNEL_RADIUS, dtype)
    src = widen_pixels(image).to(dtype)
    a = m * y - x * x - x * (m - 1)
    c = x * _scalar(nsig_b, dtype, x.device) * torch.sqrt(2 * (m - 1))
    px_valid = mask_valid & (src <= _scalar(trusted_max, dtype, src.device))
    n_ok = (m >= min_count) & (m > 1)
    return src, m, x, px_valid & n_ok & (a > c)


def dispersion(
    image: torch.Tensor,
    mask: torch.Tensor,
    trusted_max: float,
    *,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    nsig_s: float = DEFAULT_NSIG_S,
    dtype: torch.dtype = torch.float64,
) -> torch.Tensor:
    """Dispersion threshold -> bool strong-pixel mask
    (reference: thresholding.cu:145-234)."""
    src, m, x, ok = _background_test(image, mask, trusted_max, min_count, nsig_b, dtype)
    b = m * src - x
    d = _scalar(nsig_s, dtype, x.device) * torch.sqrt(x * m)
    return ok & (b > d)


def dispersion_first_pass(
    image,
    mask,
    trusted_max,
    *,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    dtype: torch.dtype = torch.float64,
):
    """Extended first pass: variance (background) test only
    (reference: thresholding.cu:253-342)."""
    return _background_test(image, mask, trusted_max, min_count, nsig_b, dtype)[3]


def erode(dispersion_mask: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Erosion of the first-pass mask (reference: erosion.cu:53-143): a
    signal pixel survives iff no valid background pixel lies within
    Chebyshev distance 2."""
    bg = ((mask != 0) & ~dispersion_mask).to(torch.int32)
    return dispersion_mask & (box_sum(bg, EROSION_CHEBYSHEV_DISTANCE) == 0)


def dispersion_second_pass(
    image,
    mask,
    survived,
    trusted_max,
    *,
    nsig_s: float = DEFAULT_NSIG_S,
    dtype: torch.dtype = torch.float64,
):
    """Extended final pass over the r=5 window
    (reference: thresholding.cu:360-491)."""
    img = widen_pixels(image).to(dtype)
    zero = torch.zeros((), dtype=dtype, device=img.device)
    bg = (mask != 0) & ~survived
    n = box_sum(bg.to(dtype), KERNEL_RADIUS_EXTENDED)
    x = box_sum(torch.where(bg, img, zero), KERNEL_RADIUS_EXTENDED)

    # mean = x/n for n > 1 else 0 (quirk preserved from thresholding.cu:482)
    mean = torch.where(n > 1, x / torch.clamp(n, min=1), zero)
    local_ok = img >= mean + _scalar(nsig_s, dtype, img.device) * torch.sqrt(mean)

    px_valid = (mask != 0) & (img <= _scalar(trusted_max, dtype, img.device))
    return (
        px_valid
        & (n > 0)
        & survived
        & (img > _scalar(DEFAULT_THRESHOLD, dtype, img.device))
        & local_ok
    )


def dispersion_extended(
    image,
    mask,
    trusted_max,
    *,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    nsig_s: float = DEFAULT_NSIG_S,
    dtype: torch.dtype = torch.float64,
):
    """Full three-stage extended algorithm
    (reference: spotfinder/spotfinder.cu:213-347)."""
    first = dispersion_first_pass(
        image, mask, trusted_max, min_count=min_count, nsig_b=nsig_b, dtype=dtype
    )
    survived = erode(first, mask)
    return dispersion_second_pass(
        image, mask, survived, trusted_max, nsig_s=nsig_s, dtype=dtype
    )
