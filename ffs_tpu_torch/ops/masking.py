"""Resolution masking (reference: spotfinder/kernels/masking.cu:27-186).

Counterpart of :mod:`ffs_tpu.ops.masking`, computed once per collection on
the processor's device.  Perpendicular-detector assumption:
d = lambda / (2 sin(0.5 atan(r/D))).
"""

from __future__ import annotations

import torch


def resolution_mask(
    mask: torch.Tensor,
    wavelength: float,
    distance: float,
    beam_center_x: float,
    beam_center_y: float,
    pixel_size_x: float,
    pixel_size_y: float,
    dmin: float = -1.0,
    dmax: float = -1.0,
) -> torch.Tensor:
    """Apply a [dmin, dmax] resolution filter to a validity mask.

    Units mirror the reference kernel: ``distance`` and pixel sizes in
    metres, wavelength in Angstroms, beam centre in pixels.  Already-masked
    pixels stay masked.  Returns a uint8 mask (1 valid, 0 masked) on the
    mask's device.
    """
    h, w = mask.shape[-2], mask.shape[-1]
    dev = mask.device
    ys = (torch.arange(h, dtype=torch.float64, device=dev) + 0.5 - beam_center_y) * pixel_size_y
    xs = (torch.arange(w, dtype=torch.float64, device=dev) + 0.5 - beam_center_x) * pixel_size_x
    r = torch.sqrt(ys[:, None] ** 2 + xs[None, :] ** 2)
    theta = 0.5 * torch.atan(r / distance)
    d = wavelength / (2.0 * torch.sin(theta))

    keep = torch.ones((h, w), dtype=torch.bool, device=dev)
    if dmin > 0:
        keep &= d >= dmin
    if dmax > 0:
        keep &= d <= dmax
    return ((mask != 0) & keep).to(torch.uint8)
