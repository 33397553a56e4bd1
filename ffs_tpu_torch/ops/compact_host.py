"""Host stream compaction from the fused kernel's packed strong words.

Takes the packed-path split one stage earlier than :mod:`ops.cc2d_host`:
the device's job ends at the ~2-4 MB/frame combined [pc | w32] rows
(:func:`ffs_tpu.ops.dispersion_pallas.dispersion_packed_raw`), and the host
expands the set bits to (linear index, intensity) against its own decoded
frame copy — no device compaction pass and no compact-array round trip
(the reference's GPU-threshold / CPU-connected-components architecture,
connected_components.cc:24-31, whose host loop scans the result mask the
same way).

Production-viable only with locally-attached hardware: the d2h transfer of
the packed words is ~0.2 ms at PCIe rates but ~60 ms over a slow remote
link, which is why ``SpotfindConfig.compact_backend`` defaults to "device".
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils.native import lib


def _compact_pcw_numpy(
    pcw: np.ndarray, image: np.ndarray, width: int, rows: int, nwl: int
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised NumPy fallback (same raster order as the native scan)."""
    words = pcw[:rows, nwl:]
    rr, jj = np.nonzero(words)
    if len(rr) == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    w = words[rr, jj].astype(np.uint32)
    bits = (w[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    k, t = np.nonzero(bits)  # sorted by (word raster order, bit) = raster
    x = (jj[k] * 32 + t).astype(np.int64)
    y = rr[k].astype(np.int64)
    lin = (y * width + x).astype(np.int32)
    inten = image[y, x].astype(np.int32)
    return lin, inten


def compact_pcw_host(
    pcw: np.ndarray, image: np.ndarray, width: int
) -> tuple[np.ndarray, np.ndarray]:
    """Expand packed strong words to raster-ordered (linear_index, intensity).

    ``pcw``: (H', 2*nwl) i32 combined rows (trimmed or strip-padded — only
    the first ``image.shape[0]`` rows are scanned; padded rows are all-zero
    by construction).  ``image``: the host (H, W) frame copy (u8/u16/u32 or
    i32).  Intensities are zero-extended to i32, matching the device
    compaction's widened gather.
    """
    pcw = np.ascontiguousarray(pcw, dtype=np.int32)
    if image.ndim != 2:
        image = image.reshape(image.shape[-2:])
    rows = min(pcw.shape[0], image.shape[0])
    nwl = pcw.shape[1] // 2
    # exact total from the pc half (inclusive within-row word prefix)
    total = int(pcw[:rows, nwl - 1].sum())
    native = lib()
    # the native scan zero-extends raw bytes: correct for u8/u16/u32 and
    # (identity) i32; anything else (signed sub-32-bit, floats) must take
    # the NumPy path, whose astype matches the device widening convention
    native_ok = (
        native is not None
        and hasattr(native, "ffs_compact_pcw")
        and (
            (image.dtype.kind == "u" and image.dtype.itemsize in (1, 2, 4))
            or image.dtype == np.int32
        )
    )
    if not native_ok:
        lin, inten = _compact_pcw_numpy(pcw, image, width, rows, nwl)
        if len(lin) != total:
            raise RuntimeError(
                f"compact_pcw_host count mismatch: scanned {len(lin)} set "
                f"bits but the prefix counts sum to {total}"
            )
        return lin, inten
    img = np.ascontiguousarray(image)
    out_lin = np.empty(total, np.int32)
    out_val = np.empty(total, np.int32)
    fn = native.ffs_compact_pcw
    fn.restype = ctypes.c_longlong
    n = fn(
        pcw.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_longlong(rows),
        ctypes.c_longlong(nwl),
        img.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_longlong(img.shape[-1]),
        ctypes.c_int32(img.dtype.itemsize),
        ctypes.c_longlong(width),
        out_lin.ctypes.data_as(ctypes.c_void_p),
        out_val.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_longlong(total),
    )
    if int(n) != total:
        raise RuntimeError(
            f"ffs_compact_pcw count mismatch: scanned {int(n)} set bits but "
            f"the prefix counts sum to {total}"
        )
    return out_lin, out_val
