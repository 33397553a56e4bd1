"""Module-wise views of Eiger detector frames.

Equivalent of the reference's ImageModules (reference:
h5read/include/h5read.h:149-170): expose an (n_slow, n_fast, mod_h, mod_w)
view of a full frame with the inter-module gaps stripped.  The port's copy
of :mod:`ffs_tpu.io.modules` (NumPy only).
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    E2XE_4M_NFAST,
    E2XE_4M_NSLOW,
    E2XE_16M_NFAST,
    E2XE_16M_NSLOW,
    E2XE_GAP_FAST,
    E2XE_GAP_SLOW,
    E2XE_MOD_FAST,
    E2XE_MOD_SLOW,
)

_LAYOUTS = {
    "16M": (E2XE_16M_NSLOW, E2XE_16M_NFAST),
    "4M": (E2XE_4M_NSLOW, E2XE_4M_NFAST),
}


def image_modules(image: np.ndarray, detector: str = "16M") -> np.ndarray:
    """Stack the modules of a frame -> (n_slow, n_fast, MOD_SLOW, MOD_FAST)."""
    n_slow, n_fast = _LAYOUTS[detector]
    out = np.empty(
        (n_slow, n_fast, E2XE_MOD_SLOW, E2XE_MOD_FAST), dtype=image.dtype
    )
    for my in range(n_slow):
        r0 = my * (E2XE_MOD_SLOW + E2XE_GAP_SLOW)
        for mx in range(n_fast):
            c0 = mx * (E2XE_MOD_FAST + E2XE_GAP_FAST)
            out[my, mx] = image[r0 : r0 + E2XE_MOD_SLOW, c0 : c0 + E2XE_MOD_FAST]
    return out


def modules_to_image(modules: np.ndarray, detector: str = "16M") -> np.ndarray:
    """Inverse of image_modules; gaps are zero-filled."""
    n_slow, n_fast = _LAYOUTS[detector]
    h = n_slow * E2XE_MOD_SLOW + (n_slow - 1) * E2XE_GAP_SLOW
    w = n_fast * E2XE_MOD_FAST + (n_fast - 1) * E2XE_GAP_FAST
    out = np.zeros((h, w), dtype=modules.dtype)
    for my in range(n_slow):
        r0 = my * (E2XE_MOD_SLOW + E2XE_GAP_SLOW)
        for mx in range(n_fast):
            c0 = mx * (E2XE_MOD_FAST + E2XE_GAP_FAST)
            out[r0 : r0 + E2XE_MOD_SLOW, c0 : c0 + E2XE_MOD_FAST] = modules[my, mx]
    return out


def draw_image_data(data: np.ndarray, x: int, y: int, w: int, h: int) -> str:
    """ASCII dump of an image region (equivalent of the reference's
    draw_image_data debug helper, include/common.hpp:62-230)."""
    region = np.asarray(data)[y : y + h, x : x + w]
    lines = [f"[{x},{y}] -> [{x + w},{y + h}]"]
    for row in region:
        lines.append(" ".join(f"{int(v):5d}" for v in row))
    return "\n".join(lines)
