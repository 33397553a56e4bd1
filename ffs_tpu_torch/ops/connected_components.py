"""Connected components and spot statistics over compacted strong pixels,
in plain PyTorch.

Counterpart of :mod:`ffs_tpu.ops.connected_components` (the per-frame and
flat-batch forms).  The f64 default path runs its 2D connected components
on the device through these functions, and so does the batched path with
``cc_backend="device"``; the f32 kernel path labels on the host by default
(ffs_tpu.ops.cc2d_host).  Labels are deterministic whatever the algorithm:
a pixel's root is the smallest slot of its 4-connected component, i.e.
the component's minimum linear index, so spot ids come out in raster order
of their roots exactly as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 2**30  # linear-index sentinel of padding slots (sorts after every pixel)
INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1

DEFAULT_MAX_SPOTS = 8192


class CompactPixels(NamedTuple):
    """Strong pixels, compacted in raster order (fixed size K): the first
    ``count`` slots are valid (when ``count <= K``), every later slot holds
    linear_index == BIG and intensity 0."""

    linear_index: torch.Tensor  # (K,) int32, BIG padding
    intensity: torch.Tensor  # (K,) int32, 0 padding
    count: torch.Tensor  # () int32 number of strong pixels (may exceed K)


def gather_i32(image: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Pixel values at flat ``index`` as int32, matching the jnp
    ``astype(int32)`` (u16 zero-extends, u32 keeps its bit pattern)."""
    flat = image.reshape(-1)
    if flat.dtype == torch.uint16:
        return flat.view(torch.int16)[index].to(torch.int32) & 0xFFFF
    if flat.dtype == torch.uint32:
        return flat.view(torch.int32)[index]
    return flat[index].to(torch.int32)


def compact_strong_pixels(
    strong: torch.Tensor, image: torch.Tensor, *, max_pixels: int = 32768
) -> CompactPixels:
    """Stream-compact a dense (H, W) strong mask in raster order."""
    flat = strong.reshape(-1)
    count = flat.sum(dtype=torch.int32)
    pos = torch.nonzero(flat, as_tuple=True)[0][:max_pixels]
    n = pos.shape[0]
    lin = torch.full((max_pixels,), BIG, dtype=torch.int32, device=strong.device)
    lin[:n] = pos.to(torch.int32)
    inten = torch.zeros(max_pixels, dtype=torch.int32, device=strong.device)
    inten[:n] = gather_i32(image, pos)
    return CompactPixels(lin, inten, count)


def neighbour_slots(lin: torch.Tensor, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Slots of each pixel's up and down neighbour (own slot when absent or
    for padding), by binary search of lin -/+ width in the sorted indices."""
    k = lin.shape[0]
    slots = torch.arange(k, dtype=torch.int32, device=lin.device)
    in_spot = lin < BIG
    lin64 = lin.to(torch.int64)

    def find(target: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
        pos = torch.searchsorted(lin64, target).clamp(max=k - 1)
        hit = ok & (lin64[pos] == target)
        return torch.where(hit, pos.to(torch.int32), slots)

    nbu = find(lin64 - width, in_spot & (lin64 >= width))
    nbd = find(lin64 + width, in_spot)
    return nbu, nbd


def label_compact_pixels(
    pixels: CompactPixels,
    *,
    width: int,
    neighbors: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """4-connected component roots over compacted pixels.

    Returns (K,) int32: the slot of each pixel's component root (the
    component's minimum linear index); its own slot for padding.  Horizontal
    neighbours are consecutive slots, so a run collapses to its start slot;
    vertical neighbour slots come from ``neighbors`` (``compact_from_pcw``)
    or a binary search.  Labels then converge by min-propagation over the
    vertical edges, run-min restore and pointer jumping.
    """
    lin = pixels.linear_index
    k = lin.shape[0]
    dev = lin.device
    slots = torch.arange(k, dtype=torch.int64, device=dev)
    in_spot = lin < BIG

    col = lin % width
    same_run = torch.zeros(k, dtype=torch.bool, device=dev)
    same_run[1:] = (lin[1:] == lin[:-1] + 1) & (col[1:] != 0) & in_spot[1:]
    run_id = torch.cumsum((~same_run).to(torch.int64), 0) - 1
    n_runs = int(run_id[-1]) + 1 if k else 0
    # run start slot: slots ascend, so the run's minimum slot
    lbl = torch.full((n_runs,), k, dtype=torch.int64, device=dev).scatter_reduce(
        0, run_id, slots, "amin"
    )[run_id]

    nbu, nbd = neighbors if neighbors is not None else neighbour_slots(lin, width)
    nbu = nbu.to(torch.int64)
    nbd = nbd.to(torch.int64)
    while True:
        prop = torch.minimum(lbl, torch.minimum(lbl[nbu], lbl[nbd]))
        prop = torch.full((n_runs,), k, dtype=torch.int64, device=dev).scatter_reduce(
            0, run_id, prop, "amin"
        )[run_id]
        new = torch.minimum(prop, prop[prop])
        if torch.equal(new, lbl):
            return new.to(torch.int32)
        lbl = new


class SpotTable(NamedTuple):
    """Fixed-size (S,) per-spot statistics; rows beyond ``n_spots`` invalid."""

    n_spots: torch.Tensor  # () int32
    valid: torch.Tensor  # (S,) bool
    n_pixels: torch.Tensor  # (S,) int32
    sum_intensity: torch.Tensor  # (S,)
    com_x: torch.Tensor  # (S,) intensity-weighted centre (+0.5 px convention)
    com_y: torch.Tensor
    com_z: torch.Tensor
    x_min: torch.Tensor  # (S,) int32 bounding boxes (inclusive)
    x_max: torch.Tensor
    y_min: torch.Tensor
    y_max: torch.Tensor
    z_min: torch.Tensor
    z_max: torch.Tensor
    peak_x: torch.Tensor  # (S,) int32 peak pixel (deterministic tie-break)
    peak_y: torch.Tensor
    peak_z: torch.Tensor


def spot_table_from_pixels(
    pixels: CompactPixels,
    root_slot: torch.Tensor,
    *,
    width: int,
    max_spots: int = DEFAULT_MAX_SPOTS,
    dtype: torch.dtype = torch.float32,
    frame_rows: int | None = None,
) -> SpotTable:
    """Per-spot statistics from compacted, labelled pixels.

    Single-frame form (``frame_rows=None``): z = 0 for every pixel.
    Flat-batch form (``frame_rows=h``): the linear indices are tall,
    ``(b*(h+1) + y)*W + x`` (``ops.compact.compact_from_pcw_segmented``), so
    y comes back modulo the (h+1)-row pitch and the frame b becomes z; one
    call tabulates a whole batch, and the raster tie-break order is the
    reference's (z, y, x) order.  The JAX package's ``peak_key_slots`` fold
    is a TPU fast path with the same result; the port does not need it.

    Spot ids follow the raster order of the roots; spots past ``max_spots``
    fall into a dropped overflow segment (callers check ``n_spots``).  The
    per-spot sums accumulate in slot order on the CPU, as XLA's CPU
    segment_sum does.  On a GPU the order of the atomic adds varies, so
    there the float32 terms (integer-valued: each product is rounded to
    float32 first, as on the CPU) add up in float64, exactly while a sum
    stays below 2^53, and round to float32 once: the same sums whatever
    the order, so that a frame's table does not depend on the run or on
    the batch it came in.  Where every partial sum is an integer below
    2^24 this is the CPU's result bit for bit.
    """
    lin = pixels.linear_index
    k = lin.shape[0]
    dev = lin.device
    slots = torch.arange(k, dtype=torch.int32, device=dev)
    in_spot = lin < BIG
    root_slot = root_slot.to(torch.int64)

    is_root = (in_spot & (root_slot == slots)).to(torch.int32)
    spot_seq = torch.cumsum(is_root, 0, dtype=torch.int32) - is_root
    n_spots = is_root.sum(dtype=torch.int32)
    spot_id = spot_seq[root_slot]

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    px_x = torch.where(in_spot, lin % width, zero)
    row_t = torch.div(lin, width, rounding_mode="floor")
    if frame_rows is not None:
        px_z = torch.where(in_spot, torch.div(row_t, frame_rows + 1, rounding_mode="floor"), zero)
        px_y = torch.where(in_spot, row_t - px_z * (frame_rows + 1), zero)
    else:
        px_y = torch.where(in_spot, row_t, zero)
        px_z = torch.zeros_like(px_x)
    sid = torch.where(in_spot, torch.clamp(spot_id, max=max_spots), max_spots).to(torch.int64)

    inten = pixels.intensity.to(dtype)
    cols = torch.stack(
        [torch.ones_like(inten), inten, inten * px_x.to(dtype), inten * px_y.to(dtype)],
        dim=1,
    )
    cols = torch.where(in_spot[:, None], cols, torch.zeros((), dtype=dtype, device=dev))
    acc = torch.float64 if dev.type == "cuda" else dtype  # order-free sums on the card
    fsum = torch.zeros((max_spots + 1, 4), dtype=acc, device=dev).index_add_(0, sid, cols.to(acc))
    fsum = fsum[:max_spots].to(dtype)
    n_pixels = fsum[:, 0].to(torch.int32)
    sum_i, sum_ix, sum_iy = fsum[:, 1], fsum[:, 2], fsum[:, 3]

    # mins ride one max reduction as negated columns (exact for integers);
    # z is constant within a spot (frames never bridge), so z_max == z_min
    pad6 = torch.tensor([-1, -1, -1, -BIG, -BIG, -BIG], dtype=torch.int32, device=dev)
    vals = torch.where(
        in_spot[:, None],
        torch.stack([px_x, px_y, pixels.intensity, -px_x, -px_y, -px_z], dim=1),
        pad6,
    )
    imaxs = torch.full((max_spots + 1, 6), INT32_MIN, dtype=torch.int32, device=dev)
    imaxs = imaxs.scatter_reduce(0, sid[:, None].expand(-1, 6), vals, "amax")[:max_spots]
    x_max, y_max = imaxs[:, 0], imaxs[:, 1]
    x_min, y_min, z_min = -imaxs[:, 3], -imaxs[:, 4], -imaxs[:, 5]
    has_px = n_pixels > 0
    z_max = torch.where(has_px, z_min, -1)
    z_min = torch.where(has_px, z_min, BIG)

    # peak pixel: max intensity, ties -> smallest linear index
    # (reference: connected_components.cc:143-157)
    peak_i = imaxs[:, 2]
    is_peak = in_spot & (pixels.intensity == peak_i[torch.clamp(sid, max=max_spots - 1)])
    peak_lin = torch.full((max_spots + 1,), INT32_MAX, dtype=torch.int32, device=dev)
    peak_lin = peak_lin.scatter_reduce(
        0, sid, torch.where(is_peak, lin, BIG), "amin"
    )[:max_spots]
    peak_x = peak_lin % width
    peak_row_t = torch.where(
        peak_lin < BIG, torch.div(peak_lin, width, rounding_mode="floor"), BIG
    )
    if frame_rows is not None:
        peak_z = torch.where(
            peak_lin < BIG, torch.div(peak_row_t, frame_rows + 1, rounding_mode="floor"), 0
        )
        peak_y = torch.where(peak_lin < BIG, peak_row_t - peak_z * (frame_rows + 1), BIG)
    else:
        peak_y = peak_row_t
        peak_z = torch.zeros_like(peak_x)

    one = torch.ones((), dtype=dtype, device=dev)
    safe_sum = torch.where(sum_i > 0, sum_i, one)
    valid = torch.arange(max_spots, device=dev) < torch.clamp(n_spots, max=max_spots)
    return SpotTable(
        n_spots=n_spots,
        valid=valid,
        n_pixels=n_pixels,
        sum_intensity=sum_i,
        com_x=sum_ix / safe_sum + 0.5,
        com_y=sum_iy / safe_sum + 0.5,
        # z is constant within a spot, so the weighted mean is z + 0.5
        com_z=torch.where(has_px, z_min, 0).to(dtype) + 0.5,
        x_min=x_min,
        x_max=x_max,
        y_min=y_min,
        y_max=y_max,
        z_min=z_min,
        z_max=z_max,
        peak_x=peak_x,
        peak_y=peak_y,
        peak_z=peak_z,
    )


def peak_centroid_distance(table: SpotTable, dtype: torch.dtype) -> torch.Tensor:
    """Euclidean distance between the peak pixel centre and the centroid
    (reference: connected_components.hpp:111-206), computed in ``dtype``."""
    dx = table.peak_x.to(dtype) + 0.5 - table.com_x.to(dtype)
    dy = table.peak_y.to(dtype) + 0.5 - table.com_y.to(dtype)
    dz = table.peak_z.to(dtype) + 0.5 - table.com_z.to(dtype)
    return torch.sqrt(dx * dx + dy * dy + dz * dz)


def filter_spots(
    table: SpotTable,
    min_spot_size: int,
    max_peak_centroid_separation: float,
    *,
    dtype: torch.dtype = torch.float64,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spot filters (reference: connected_components.cc:207-236).

    Returns (keep_mask, n_filtered_by_size, n_filtered_by_separation).  A
    filter is disabled when its parameter is <= 0, as in the reference; the
    size filter applies before the separation filter.  ``dtype`` is the
    precision of the separation test: the JAX package evaluates it in
    float64 under its x64 mode and in float32 inside its x64-off Pallas
    scope.
    """
    size_ok = table.n_pixels >= min_spot_size if min_spot_size > 0 else torch.ones_like(table.valid)
    if max_peak_centroid_separation > 0:
        limit = torch.tensor(max_peak_centroid_separation, dtype=dtype, device=table.valid.device)
        sep_ok = peak_centroid_distance(table, dtype) <= limit
    else:
        sep_ok = torch.ones_like(table.valid)
    n_size = (table.valid & ~size_ok).sum(dtype=torch.int32)
    n_sep = (table.valid & size_ok & ~sep_ok).sum(dtype=torch.int32)
    return table.valid & size_ok & sep_ok, n_size, n_sep


# ---------------------------------------------------------------------------
# Dense labelling (reference and testing path; the production pipeline uses
# the sparse compaction + label_compact_pixels route above)
# ---------------------------------------------------------------------------


def _neighbor_min(lbl: torch.Tensor) -> torch.Tensor:
    """Min over the 4-neighbourhood (and self), BIG-padded at the borders."""
    out = lbl.clone()
    out[:-1] = torch.minimum(out[:-1], lbl[1:])
    out[1:] = torch.minimum(out[1:], lbl[:-1])
    out[:, :-1] = torch.minimum(out[:, :-1], lbl[:, 1:])
    out[:, 1:] = torch.minimum(out[:, 1:], lbl[:, :-1])
    return out


def label_components_2d(strong: torch.Tensor) -> torch.Tensor:
    """Dense 4-connected labels for a bool (H, W) mask, on its device.

    Returns int32 (H, W): for strong pixels, the linear index of the
    component's root (its minimum linear index); BIG elsewhere.  Each round
    takes the 4-neighbour minimum and one pointer jump, until no label
    changes (one host read a round).  ``label_components_2d.rounds`` holds
    the last call's round count.
    """
    h, w = strong.shape
    big = torch.tensor(BIG, dtype=torch.int32, device=strong.device)
    lin = torch.arange(h * w, dtype=torch.int32, device=strong.device).reshape(h, w)
    lbl = torch.where(strong, lin, big)
    rounds = 0
    while True:
        rounds += 1
        prop = torch.where(strong, _neighbor_min(lbl), big)
        jumped = prop.reshape(-1)[prop.clamp(0, h * w - 1).to(torch.int64)]
        new = torch.where(strong, torch.minimum(prop, jumped), big)
        if torch.equal(new, lbl):
            label_components_2d.rounds = rounds
            return new
        lbl = new


label_components_2d.rounds = 0
