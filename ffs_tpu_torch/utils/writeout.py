"""Diagnostic image writeout (reference: spotfinder/spotfinder.cc:939-994).

PNG renders of frames with strong pixels highlighted and shoeboxes outlined,
plus the red/white mask renders, matching the reference's lodepng output.
"""

from __future__ import annotations

import numpy as np


def _save_png(path: str, rgb: np.ndarray) -> bool:
    try:
        from PIL import Image

        Image.fromarray(rgb, mode="RGB").save(path)
        return True
    except ImportError:
        return False


def write_mask_png(path: str, mask: np.ndarray) -> bool:
    """White = valid, red = masked (spotfinder.cc:621-645)."""
    h, w = mask.shape
    rgb = np.full((h, w, 3), 255, dtype=np.uint8)
    bad = mask == 0
    rgb[bad] = (255, 0, 0)
    return _save_png(path, rgb)


def write_image_png(
    path: str,
    image: np.ndarray,
    strong: np.ndarray | None = None,
    boxes: np.ndarray | None = None,
) -> bool:
    """Grayscale render (255.99 - 10*I clamp) with red strong pixels and
    blue shoebox borders (spotfinder.cc:939-988)."""
    gray = np.clip(255.99 - image.astype(np.float32) * 10, 0, 255).astype(np.uint8)
    rgb = np.stack([gray, gray, gray], axis=-1)
    h, w = image.shape
    if boxes is not None:
        for x0, x1, y0, y1 in boxes:
            for edge in range(5, 8):
                t, b = max(y0 - edge, 0), min(y1 + edge, h - 1)
                l, r = max(x0 - edge, 0), min(x1 + edge, w - 1)
                rgb[t, l : r + 1] = (0, 0, 255)
                rgb[b, l : r + 1] = (0, 0, 255)
                rgb[t : b + 1, l] = (0, 0, 255)
                rgb[t : b + 1, r] = (0, 0, 255)
    if strong is not None:
        rgb[strong.astype(bool)] = (255, 0, 0)
    return _save_png(path, rgb)
