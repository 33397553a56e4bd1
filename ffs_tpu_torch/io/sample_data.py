"""Deterministic synthetic Eiger 16M sample data.

Bit-identical reimplementation of the reference's hardware-free test fixture
(reference: h5read/src/h5read.c:186-277, h5read_generate_samples at
h5read.c:1158-1189): six deterministic Eiger-16M frames plus the module-gap
mask.  Image 5 uses the PCG32 stream (seed state=0, inc=1) over module
pixels in raster order; here the sequential generator is replaced by an
affine jump-doubling construction so the whole stream vectorises in NumPy.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    E2XE_16M_FAST,
    E2XE_16M_NFAST,
    E2XE_16M_NSLOW,
    E2XE_16M_SLOW,
    E2XE_GAP_FAST,
    E2XE_GAP_SLOW,
    E2XE_MOD_FAST,
    E2XE_MOD_SLOW,
)

NUM_SAMPLE_IMAGES = 6

_PCG_MULT = np.uint64(6364136223846793005)


def _pcg32_states(n: int, state0: int = 0, inc: int = 1) -> np.ndarray:
    """States of the PCG32 LCG before each of the first ``n`` outputs.

    The LCG step is ``s' = s * M + inc`` (mod 2^64).  Composing the affine
    map with itself doubles the stride, so the full state array is built in
    O(log n) vectorised rounds instead of n sequential steps.
    """
    with np.errstate(over="ignore"):
        states = np.empty(n, dtype=np.uint64)
        states[0] = np.uint64(state0)
        filled = 1
        # Affine coefficients for advancing `filled` steps: s -> a*s + b
        a = _PCG_MULT
        b = np.uint64(inc)
        while filled < n:
            take = min(filled, n - filled)
            states[filled : filled + take] = states[:take] * a + b
            # Compose the affine map with itself: advance 2*filled steps
            b = a * b + b
            a = a * a
            filled += take
    return states


def _pcg32_output(states: np.ndarray) -> np.ndarray:
    """PCG32 XSH-RR output function, vectorised (uint64 states -> uint32)."""
    xorshifted = (((states >> np.uint64(18)) ^ states) >> np.uint64(27)).astype(
        np.uint32
    )
    rot = (states >> np.uint64(59)).astype(np.uint32)
    neg = (np.uint32(0) - rot) & np.uint32(31)
    with np.errstate(over="ignore"):
        return (xorshifted >> rot) | (xorshifted << neg)


def module_slices() -> list[tuple[slice, slice]]:
    """(row, col) slices of each Eiger 16M module, raster order."""
    out = []
    for mody in range(E2XE_16M_NSLOW):
        row0 = mody * (E2XE_MOD_SLOW + E2XE_GAP_SLOW)
        for modx in range(E2XE_16M_NFAST):
            col0 = modx * (E2XE_MOD_FAST + E2XE_GAP_FAST)
            out.append(
                (slice(row0, row0 + E2XE_MOD_SLOW), slice(col0, col0 + E2XE_MOD_FAST))
            )
    return out


def generate_mask() -> np.ndarray:
    """Module mask: 1 on module pixels, 0 in the inter-module gaps."""
    mask = np.zeros((E2XE_16M_SLOW, E2XE_16M_FAST), dtype=np.uint8)
    for rows, cols in module_slices():
        mask[rows, cols] = 1
    return mask


def generate_sample_image(n: int, dtype=np.uint16) -> np.ndarray:
    """Sample image ``n`` (0..5), shape (E2XE_16M_SLOW, E2XE_16M_FAST)."""
    shape = (E2XE_16M_SLOW, E2XE_16M_FAST)
    if n == 0:
        return np.zeros(shape, dtype=dtype)
    if n == 1:
        # I=1 on every module pixel
        return generate_mask().astype(dtype)
    if n == 2:
        # I=100 every 42 pixels in both axes (gaps included)
        data = np.zeros(shape, dtype=dtype)
        data[::42, ::42] = 100
        return data
    if n == 3:
        # I = x (fast-axis coordinate)
        return np.broadcast_to(
            np.arange(E2XE_16M_FAST, dtype=dtype), shape
        ).copy()
    if n == 4:
        # I = y (slow-axis coordinate)
        return np.broadcast_to(
            np.arange(E2XE_16M_SLOW, dtype=dtype)[:, None], shape
        ).copy()
    if n == 5:
        # PCG32 background in [0, 10) over module pixels in raster order
        n_mod_px = E2XE_MOD_SLOW * E2XE_MOD_FAST
        n_total = E2XE_16M_NSLOW * E2XE_16M_NFAST * n_mod_px
        vals = (_pcg32_output(_pcg32_states(n_total)) % np.uint32(10)).astype(dtype)
        data = np.zeros(shape, dtype=dtype)
        per_module = vals.reshape(-1, E2XE_MOD_SLOW, E2XE_MOD_FAST)
        for i, (rows, cols) in enumerate(module_slices()):
            data[rows, cols] = per_module[i]
        return data
    raise ValueError(f"Unhandled sample image {n}")


class SampleReader:
    """Reader over the six synthetic frames, mirroring the reference's
    implicit-sample mode (reference: h5read/src/h5read.c:1158-1189)."""

    def __init__(self, num_images: int | None = None, dtype=np.uint16):
        self.dtype = np.dtype(dtype)
        self._num_images = num_images or NUM_SAMPLE_IMAGES
        self._mask = generate_mask()

    @property
    def image_shape(self) -> tuple[int, int]:
        return (E2XE_16M_SLOW, E2XE_16M_FAST)

    def get_number_of_images(self) -> int:
        return self._num_images

    def get_mask(self) -> np.ndarray:
        return self._mask

    def get_trusted_range(self) -> tuple[float, float]:
        return (0, float(np.iinfo(self.dtype).max))

    def get_wavelength(self):
        return None

    def get_pixel_size(self) -> tuple[float, float]:
        return (0.75e-6, 0.75e-6)  # metres (slow, fast)

    def get_beam_center(self) -> tuple[float, float]:
        return (E2XE_16M_SLOW / 2.0, E2XE_16M_FAST / 2.0)  # px (slow, fast)

    def get_detector_distance(self) -> float:
        return 0.5  # metres

    def get_oscillation(self) -> tuple[float, float]:
        return (0.0, 0.0)  # still set

    def get_element_size(self) -> int:
        return self.dtype.itemsize

    def is_image_available(self, index: int) -> bool:
        return index < self._num_images

    def get_image(self, index: int) -> np.ndarray:
        return generate_sample_image(index % NUM_SAMPLE_IMAGES, dtype=self.dtype)
