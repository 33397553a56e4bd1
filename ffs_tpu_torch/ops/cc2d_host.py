"""Host-side 2D connected components over compact strong pixels.

The production split mirrors the reference: the accelerator thresholds the
frame and stream-compacts the strong pixels; the host labels the resulting
few-thousand-entry list (reference: the CUDA kernels threshold on the GPU
and boost::graph connected components run on the CPU,
spotfinder/connected_components/connected_components.cc:17-139).  On-device
sparse gathers cost ~10 ns/element on TPU, so labelling ~3k pixels here
costs microseconds on the host versus milliseconds on the chip — while the
device stays busy with the next frame's dense work.

Semantics (spot ordering, centroid convention, peak tie-break, filters) are
identical to the on-device ops/connected_components.py path; tests assert
bit-equality between the two backends.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from ..utils.native import lib


@dataclass
class HostSpotTable:
    """Per-spot statistics for one frame (host arrays, raster-root order)."""

    n_spots: int
    root_lin: np.ndarray  # (n,) per-pixel root linear index
    spot_id: np.ndarray  # (n,) per-pixel dense spot id
    n_pixels: np.ndarray  # (S,)
    sum_intensity: np.ndarray  # (S,) float64
    com_x: np.ndarray  # (S,) +0.5 pixel-centre convention
    com_y: np.ndarray
    com_z: np.ndarray
    x_min: np.ndarray
    x_max: np.ndarray
    y_min: np.ndarray
    y_max: np.ndarray
    peak_x: np.ndarray
    peak_y: np.ndarray
    peak_intensity: np.ndarray


def _cc2d_numpy(lin: np.ndarray, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Pure-NumPy union-find fallback -> (root_lin, spot_id)."""
    n = len(lin)
    parent = np.arange(n, dtype=np.int64)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    cols = lin % width
    for i in range(n):
        if i > 0 and cols[i] > 0 and lin[i - 1] == lin[i] - 1:
            a, b = find(i), find(i - 1)
            if a != b:
                parent[max(a, b)] = min(a, b)
        if lin[i] >= width:
            j = np.searchsorted(lin[:i], lin[i] - width)
            if j < i and lin[j] == lin[i] - width:
                a, b = find(i), find(j)
                if a != b:
                    parent[max(a, b)] = min(a, b)
    roots = np.array([find(i) for i in range(n)])
    uniq, spot_id = np.unique(roots, return_inverse=True)
    return lin[roots], spot_id.astype(np.int32)


def cc2d(lin: np.ndarray, inten: np.ndarray, width: int) -> HostSpotTable:
    """Label one frame's compact pixels and compute per-spot statistics.

    ``lin`` must be sorted ascending (raster order) with no sentinels.
    """
    lin = np.ascontiguousarray(lin, dtype=np.int32)
    inten = np.ascontiguousarray(inten, dtype=np.int32)
    n = len(lin)
    if n == 0:
        e_i = np.zeros(0, np.int32)
        e_f = np.zeros(0, np.float64)
        return HostSpotTable(
            0, e_i, e_i, e_i, e_f, e_f, e_f, e_f,
            e_i, e_i, e_i, e_i, e_i, e_i, e_i,
        )

    native = lib()
    if native is not None and hasattr(native, "ffs_cc2d"):
        root_lin = np.empty(n, np.int32)
        spot_id = np.empty(n, np.int32)
        n_spots = ctypes.c_int32(0)
        n_px = np.empty(n, np.int32)
        sum_i = np.empty(n, np.int64)
        sum_ix = np.empty(n, np.int64)
        sum_iy = np.empty(n, np.int64)
        bbox = np.empty(4 * n, np.int32)
        peak_i = np.empty(n, np.int32)
        peak_lin = np.empty(n, np.int32)
        p = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
        rc = native.ffs_cc2d(
            p(lin), p(inten), ctypes.c_int32(n), ctypes.c_int32(width),
            p(root_lin), p(spot_id), ctypes.byref(n_spots),
            p(n_px), p(sum_i), p(sum_ix), p(sum_iy),
            p(bbox), p(peak_i), p(peak_lin),
        )
        if rc != 0:
            raise RuntimeError(f"ffs_cc2d failed: {rc}")
        s = int(n_spots.value)
        n_px = n_px[:s]
        sum_i = sum_i[:s].astype(np.float64)
        sum_ix = sum_ix[:s].astype(np.float64)
        sum_iy = sum_iy[:s].astype(np.float64)
        bbox = bbox[: 4 * s].reshape(s, 4)
        peak_i = peak_i[:s]
        peak_lin = peak_lin[:s]
    else:
        root_lin, spot_id = _cc2d_numpy(lin, width)
        s = int(spot_id.max()) + 1 if n else 0
        inten_f = inten.astype(np.float64)
        x = (lin % width).astype(np.int64)
        y = (lin // width).astype(np.int64)
        n_px = np.bincount(spot_id, minlength=s).astype(np.int32)
        sum_i = np.bincount(spot_id, weights=inten_f, minlength=s)
        sum_ix = np.bincount(spot_id, weights=inten_f * x, minlength=s)
        sum_iy = np.bincount(spot_id, weights=inten_f * y, minlength=s)
        bbox = np.empty((s, 4), np.int32)
        # per-spot extrema / peak via sort by (spot, ...) — small arrays
        bbox[:, 0] = np.full(s, 2**31 - 1)
        bbox[:, 1] = -1
        bbox[:, 2] = np.full(s, 2**31 - 1)
        bbox[:, 3] = -1
        np.minimum.at(bbox[:, 0], spot_id, x.astype(np.int32))
        np.maximum.at(bbox[:, 1], spot_id, x.astype(np.int32))
        np.minimum.at(bbox[:, 2], spot_id, y.astype(np.int32))
        np.maximum.at(bbox[:, 3], spot_id, y.astype(np.int32))
        peak_i = np.full(s, -1, np.int32)
        np.maximum.at(peak_i, spot_id, inten)
        is_peak = inten == peak_i[spot_id]
        peak_lin = np.full(s, 2**31 - 1, np.int32)
        np.minimum.at(peak_lin, spot_id[is_peak], lin[is_peak])

    safe = np.where(sum_i > 0, sum_i, 1.0)
    return HostSpotTable(
        n_spots=s,
        root_lin=root_lin,
        spot_id=spot_id,
        n_pixels=n_px,
        sum_intensity=sum_i,
        com_x=sum_ix / safe + 0.5,
        com_y=sum_iy / safe + 0.5,
        com_z=np.full(s, 0.5),
        x_min=bbox[:, 0],
        x_max=bbox[:, 1],
        y_min=bbox[:, 2],
        y_max=bbox[:, 3],
        peak_x=peak_lin % width,
        peak_y=peak_lin // width,
        peak_intensity=peak_i,
    )


def filter_spots_host(
    table: HostSpotTable,
    min_spot_size: int,
    max_peak_centroid_separation: float,
) -> tuple[np.ndarray, int, int]:
    """(keep_mask, n_filtered_by_size, n_filtered_by_separation) — identical
    semantics to ops/connected_components.py::filter_spots (a filter is
    disabled when its parameter is <= 0)."""
    size_ok = (
        table.n_pixels >= min_spot_size
        if min_spot_size > 0
        else np.ones(table.n_spots, bool)
    )
    dx = table.peak_x + 0.5 - table.com_x
    dy = table.peak_y + 0.5 - table.com_y
    dz = 0.5 - table.com_z
    sep = np.sqrt(dx * dx + dy * dy + dz * dz)
    sep_ok = (
        sep <= max_peak_centroid_separation
        if max_peak_centroid_separation > 0
        else np.ones(table.n_spots, bool)
    )
    n_size = int((~size_ok).sum())
    n_sep = int((size_ok & ~sep_ok).sum())
    return size_ok & sep_ok, n_size, n_sep
