"""Stream compaction from the packed [pc | w32] rows, in plain PyTorch.

Counterpart of :func:`ffs_tpu.ops.compact.compact_from_pcw` and
:func:`ffs_tpu.ops.compact.compact_from_pcw_segmented`.  The port owes the
same :class:`~ffs_tpu_torch.ops.connected_components.CompactPixels` values
— strong pixels in raster order, ``BIG`` padding, the exact count — not the
TPU's gather formulation: here the set bits are expanded from the nonzero
words only (a few thousand per frame), so no dense plane is rebuilt.

The measurement path's compactions, counterparts of
``compact_from_rowcum``, ``compact_from_rowcum_flat``, ``compact_from_words``
and ``compact_from_words_flat``, read the dense per-row prefix counts of
``dispersion_fused`` (a strong pixel is where the count steps) or the split
``(w32, pc)`` words.  The flat forms share one capacity across the batch and
return tall indices ``(b*(H+1) + y)*W + x``; past capacity the first K
pixels in that order are kept and ``count`` stays the true total.
"""

from __future__ import annotations

import torch

from .connected_components import (
    BIG,
    CompactPixels,
    compact_strong_pixels,
    gather_i32,
    neighbour_slots,
)


def _set_bits(words: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Every set bit of ``words`` (..., nwl) int32, in raster order: the
    index tuple of its word (leading dims and word lane) and the column
    32j+t of bit t of word j, all int64."""
    idx = torch.nonzero(words, as_tuple=True)  # raster word order
    w = words[idx].to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = torch.bitwise_right_shift(w[:, None], shifts[None, :]) & 1
    k, t = torch.nonzero(bits, as_tuple=True)  # (word, bit) raster order
    return (*(i[k] for i in idx[:-1]), idx[-1][k] * 32 + t)


def _strong_linear_indices(pcw: torch.Tensor, width: int) -> torch.Tensor:
    """Raster-ordered int64 linear indices of every set bit in (H, 2*nwl)
    combined rows (bit t of word j = column 32j+t)."""
    rows, cols = _set_bits(pcw[:, pcw.shape[-1] // 2 :])
    return rows * width + cols


def _check_i32_sort_keys(b: int, ht: int, w: int) -> None:
    """The guard of ``ffs_tpu.ops.compact._check_i32_sort_keys``: the tall
    linear indices, times the JAX CC's four sort-key tags, must fit int32.
    It also keeps every tall index below the ``BIG`` padding sentinel."""
    if b * ht * w * 4 >= 2**31:
        raise ValueError(
            f"flat batch too tall for i32 CC sort keys: B*{ht}*{w}*4 = "
            f"{b * ht * w * 4} >= 2^31; split the batch (max "
            f"{(2**31 // (4 * ht * w))} frames at this geometry)"
        )


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


def compact_from_pcw_segmented(
    images: torch.Tensor,
    pcw: torch.Tensor,
    *,
    max_pixels_per_frame: int = 4096,
    with_neighbors: bool = False,
):
    """Batch compaction with per-frame slot segments.

    ``images`` (B, H, W), ``pcw`` (B, h, 2*nwl) combined rows.  Frame b's
    strong pixels occupy slots [b*Kf, (b+1)*Kf) (Kf =
    ``max_pixels_per_frame``) in raster order, then ``BIG`` padding, so
    padding interleaves with pixels across the B*Kf slots.  Linear indices
    are tall, ``(b*(h+1) + y)*W + x``: one empty gap row per frame keeps
    4-connected components from bridging frames.

    Returns ``(pixels, counts)`` or ``(pixels, nbu, nbd, counts)``;
    ``counts`` (B,) int32 holds each frame's exact total (a frame overflows
    when ``counts[b] > Kf``) and ``pixels.count`` the batch total.  The
    neighbour slots are ``b*Kf`` plus the frame-local index of the
    neighbour, or the own slot where there is none; as in the JAX form, a
    down neighbour inside an overflowing frame may point past its segment
    (such frames are discarded by the caller).
    """
    b, h, nwl2 = pcw.shape
    nwl = nwl2 // 2
    h_img, w = images.shape[-2], images.shape[-1]
    ht = h + 1
    _check_i32_sort_keys(b, ht, w)
    kf = max_pixels_per_frame
    dev = pcw.device

    counts = pcw[:, :, nwl - 1].sum(dim=1, dtype=torch.int32)
    fb, y, x = _set_bits(pcw[:, :, nwl:])
    lin_all = (fb * ht + y) * w + x  # tall, ascending
    start = torch.cumsum(counts, 0, dtype=torch.int64) - counts  # first pixel of each frame
    local = torch.arange(lin_all.shape[0], dtype=torch.int64, device=dev) - start[fb]
    keep = local < kf
    slot = (fb * kf + local)[keep]

    lin = torch.full((b * kf,), BIG, dtype=torch.int32, device=dev)
    lin[slot] = lin_all[keep].to(torch.int32)
    inten = torch.zeros(b * kf, dtype=torch.int32, device=dev)
    inten[slot] = gather_i32(images, ((fb * h_img + y) * w + x)[keep])
    pixels = CompactPixels(lin, inten, counts.sum(dtype=torch.int32))
    if not with_neighbors:
        return pixels, counts

    # a vertical neighbour lies in the same frame (the gap rows hold no
    # pixels), so its frame-local index is its position minus the frame's
    # first one
    nbu = torch.arange(b * kf, dtype=torch.int64, device=dev)
    nbd = nbu.clone()
    n = lin_all.shape[0]
    if n:
        lin_k, fb_k = lin_all[keep], fb[keep]
        for nb, target in ((nbu, lin_k - w), (nbd, lin_k + w)):
            pos = torch.searchsorted(lin_all, target).clamp(max=n - 1)
            hit = lin_all[pos] == target
            nb[slot[hit]] = (fb_k * kf + pos - start[fb_k])[hit]
    return pixels, nbu.to(torch.int32), nbd.to(torch.int32), counts


def _strong_from_rowcum(rowcum: torch.Tensor) -> torch.Tensor:
    """Inclusive per-row prefix counts (..., H, W) -> the bool strong plane
    (the count steps by one at each strong pixel)."""
    return torch.diff(rowcum, dim=-1, prepend=torch.zeros_like(rowcum[..., :1])) != 0


def _tall_pixels(images, fb, y, x, rows: int, count, k: int) -> CompactPixels:
    """The first ``k`` strong pixels (frame, row, column; raster order over
    the batch) as tall linear indices with a ``rows + 1`` pitch, their int32
    intensities and the batch total ``count``."""
    h_img, w = images.shape[-2], images.shape[-1]
    n = min(fb.shape[0], k)
    fb, y, x = fb[:n], y[:n], x[:n]
    dev = images.device
    lin = torch.full((k,), BIG, dtype=torch.int32, device=dev)
    lin[:n] = ((fb * (rows + 1) + y) * w + x).to(torch.int32)
    inten = torch.zeros(k, dtype=torch.int32, device=dev)
    inten[:n] = gather_i32(images, (fb * h_img + y) * w + x)
    return CompactPixels(lin, inten, count)


def compact_from_rowcum(
    image: torch.Tensor, rowcum: torch.Tensor, *, max_pixels: int = 32768
) -> CompactPixels:
    """Strong pixels of one (H, W) frame in raster order, from its per-row
    prefix counts (``dispersion_fused``)."""
    return compact_strong_pixels(_strong_from_rowcum(rowcum), image, max_pixels=max_pixels)


def compact_from_rowcum_flat(
    images: torch.Tensor, rowcum: torch.Tensor, *, max_pixels_total: int = 65536
) -> CompactPixels:
    """A (B, H, W) batch's strong pixels as one tall pixel list, capacity
    ``max_pixels_total`` shared across the batch."""
    b, h, w = rowcum.shape
    _check_i32_sort_keys(b, h + 1, w)
    fb, y, x = torch.nonzero(_strong_from_rowcum(rowcum), as_tuple=True)
    count = rowcum[:, :, -1].sum(dtype=torch.int32)
    return _tall_pixels(images, fb, y, x, h, count, max_pixels_total)


def compact_from_words_flat(
    images: torch.Tensor,
    words: torch.Tensor,
    pc: torch.Tensor,
    *,
    max_pixels_total: int = 24576,
) -> CompactPixels:
    """Tall pixel list of a batch from the split packed rows of
    ``dispersion_packed``: ``words`` (B, H, nwl) strong bits (bit t of word
    j = column 32j+t), ``pc`` (B, H, nwl) their inclusive word counts."""
    b, h, _ = pc.shape
    _check_i32_sort_keys(b, h + 1, images.shape[-1])
    fb, y, x = _set_bits(words)
    count = pc[:, :, -1].sum(dtype=torch.int32)
    return _tall_pixels(images, fb, y, x, h, count, max_pixels_total)


def compact_from_words(
    image: torch.Tensor, words: torch.Tensor, pc: torch.Tensor, *, max_pixels: int = 32768
) -> CompactPixels:
    """One frame's strong pixels from its split packed rows; with a single
    frame the tall indices are the plain raster indices."""
    return compact_from_words_flat(image[None], words[None], pc[None], max_pixels_total=max_pixels)
