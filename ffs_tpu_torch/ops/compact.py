"""Stream compaction from the packed [pc | w32] rows, in plain PyTorch.

Counterpart of :func:`ffs_tpu.ops.compact.compact_from_pcw`.  The port owes
the same :class:`~ffs_tpu_torch.ops.connected_components.CompactPixels`
values — strong pixels in raster order, ``BIG`` padding, the exact count —
not the TPU's gather formulation: here the set bits are expanded from the
nonzero words only (a few thousand per frame), so no dense plane is
rebuilt.
"""

from __future__ import annotations

import torch

from .connected_components import BIG, CompactPixels, gather_i32, neighbour_slots


def _strong_linear_indices(pcw: torch.Tensor, width: int) -> torch.Tensor:
    """Raster-ordered int64 linear indices of every set bit in (H, 2*nwl)
    combined rows (bit t of word j = column 32j+t)."""
    nwl = pcw.shape[-1] // 2
    words = pcw[:, nwl:]
    rows, cols = torch.nonzero(words, as_tuple=True)  # raster word order
    w = words[rows, cols].to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=pcw.device)
    bits = torch.bitwise_right_shift(w[:, None], shifts[None, :]) & 1
    k, t = torch.nonzero(bits, as_tuple=True)  # (word, bit) raster order
    return rows[k] * width + cols[k] * 32 + t


def compact_from_pcw(
    image: torch.Tensor,
    pcw: torch.Tensor,
    *,
    max_pixels: int = 32768,
    with_neighbors: bool = False,
):
    """Single-frame compaction from combined rows.

    Returns ``CompactPixels`` (K = ``max_pixels`` slots; ``count`` is the
    exact total, which exceeds K when the frame overflows), plus the
    vertical neighbour slots (up, down; own slot when absent) with
    ``with_neighbors=True``.
    """
    h, w = image.shape
    nwl = pcw.shape[-1] // 2
    count = pcw[:, nwl - 1].sum().to(torch.int32)
    lin_all = _strong_linear_indices(pcw, w)
    n = min(lin_all.shape[0], max_pixels)
    dev = image.device
    lin = torch.full((max_pixels,), BIG, dtype=torch.int32, device=dev)
    lin[:n] = lin_all[:n].to(torch.int32)
    inten = torch.zeros(max_pixels, dtype=torch.int32, device=dev)
    inten[:n] = gather_i32(image, lin_all[:n])
    pixels = CompactPixels(lin, inten, count)
    if not with_neighbors:
        return pixels
    nbu, nbd = neighbour_slots(lin, w)
    return pixels, nbu, nbd
