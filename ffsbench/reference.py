"""The plain reference: what the spotfinder should answer for the frames the
benchmark made.

Written in plain PyTorch (the thresholds, on any device) and NumPy/SciPy (the
components, spot tables, 3D merge and variances), from the published
algorithms and the CLI's documented output conventions.  It imports nothing of
the program, and takes nothing the program made: it works from the frames the
benchmark generated.

* Thresholds: the DIALS dispersion and dispersion-extended tests in the boxed
  form (a frozen copy of the program's plain PyTorch version, whose window
  sums follow the canonical tree order), in the precision the configuration
  states, or in the one its ``control`` names.
* Components: 4-connected strong pixels in a frame; spots ordered by their
  first pixel in raster order; centroids weighted by the raw counts with the
  +0.5 pixel-centre convention; the peak is the brightest pixel, ties to the
  first in raster order.  2D filters: size, then peak-centroid separation.
* 3D merge (rotation data): components of the frame sequence, joined where a
  pixel is strong in two consecutive frames; filtered by size and
  separation; sigma_b / sigma_m variances in Kabsch space on a flat panel at
  the beam centre, as the DIALS spot finder's epilogue computes them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

MIN_COUNT, NSIG_B, NSIG_S, THRESHOLD = 3, 6.0, 3.0, 0.0
RADIUS, RADIUS_EXTENDED, EROSION_DISTANCE = 3, 5, 2

DTYPES = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}


# ---------------------------------------------------------------- thresholds


def _pow2_parts(k: int) -> list[int]:
    parts, p = [], 1
    while 2 * p <= k:
        p *= 2
    while k:
        if p <= k:
            parts.append(p)
            k -= p
        p //= 2
    return parts


def _window_axis(p: torch.Tensor, k: int, n: int, dim: int) -> torch.Tensor:
    """k-wide sliding sums along ``dim``: s2[i] = s1[i] + s1[i+1], s4[i] =
    s2[i] + s2[i+2], ..., then the power-of-two parts of k left to right."""
    parts = _pow2_parts(k)
    levels, sz = {1: p}, 1
    while sz < parts[0]:
        prev = levels[sz]
        ln = prev.shape[dim] - sz
        levels[2 * sz] = prev.narrow(dim, 0, ln) + prev.narrow(dim, sz, ln)
        sz *= 2
    acc, off = None, 0
    for part in parts:
        t = levels[part].narrow(dim, off, n)
        acc = t if acc is None else acc + t
        off += part
    return acc


def box_sum(arr: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 window sums with zero padding: rows first, then columns."""
    k = 2 * radius + 1
    h, w = arr.shape[-2], arr.shape[-1]
    rows = _window_axis(F.pad(arr, (0, 0, radius, radius)), k, h, arr.dim() - 2)
    return _window_axis(F.pad(rows, (radius, radius)), k, w, arr.dim() - 1)


def pixel_values(image: torch.Tensor) -> torch.Tensor:
    """Unsigned 16/32-bit pixels as int64 (through same-width signed views)."""
    if image.dtype == torch.uint16:
        return image.view(torch.int16).to(torch.int64) & 0xFFFF
    if image.dtype == torch.uint32:
        return image.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return image.to(torch.int64)


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _background(img, valid, trusted_max, dtype):
    zero = torch.zeros((), dtype=dtype, device=img.device)
    m = box_sum(valid.to(dtype), RADIUS)
    x = box_sum(torch.where(valid, img, zero), RADIUS)
    y = box_sum(torch.where(valid, img * img, zero), RADIUS)
    a = m * y - x * x - x * (m - 1)
    c = x * _const(NSIG_B, x) * torch.sqrt(2 * (m - 1))
    ok = valid & (img <= _const(trusted_max, img)) & (m >= MIN_COUNT) & (m > 1) & (a > c)
    return m, x, ok


def dispersion(image, mask, trusted_max: float, dtype: torch.dtype) -> torch.Tensor:
    """Strong-pixel mask of the dispersion test (7 x 7 window)."""
    img = pixel_values(image).to(dtype)
    valid = mask != 0
    m, x, ok = _background(img, valid, trusted_max, dtype)
    return ok & (m * img - x > _const(NSIG_S, x) * torch.sqrt(x * m))


def dispersion_extended(image, mask, trusted_max: float, dtype: torch.dtype) -> torch.Tensor:
    """Strong-pixel mask of the extended test: the background test, erosion
    at Chebyshev distance 2, then the 11 x 11 local-mean test."""
    img = pixel_values(image).to(dtype)
    valid = mask != 0
    _, _, first = _background(img, valid, trusted_max, dtype)
    near_bg = box_sum((valid & ~first).to(torch.int32), EROSION_DISTANCE)
    survived = first & (near_bg == 0)
    zero = torch.zeros((), dtype=dtype, device=img.device)
    bg = valid & ~survived
    n = box_sum(bg.to(dtype), RADIUS_EXTENDED)
    x = box_sum(torch.where(bg, img, zero), RADIUS_EXTENDED)
    mean = torch.where(n > 1, x / torch.clamp(n, min=1), zero)
    local_ok = img >= mean + _const(NSIG_S, img) * torch.sqrt(mean)
    return (valid & (img <= _const(trusted_max, img)) & (n > 0) & survived
            & (img > _const(THRESHOLD, img)) & local_ok)


ALGORITHMS = {"dispersion": dispersion, "dispersion_extended": dispersion_extended}


# ---------------------------------------------------------------- components


@dataclass
class FrameSpots:
    """One frame's strong pixels (raster order) and 2D spots."""

    lin: np.ndarray  # strong pixels' linear indices, ascending
    value: np.ndarray  # their counts
    n_spots: int  # spots after the size filter
    centers: np.ndarray  # (S, 3) centroids of spots past both filters


def label_pixels(lin: np.ndarray, width: int, extra_edges=()) -> np.ndarray:
    """Labels of 4-connected components over sorted pixel indices, numbered
    by each component's first pixel; ``extra_edges`` joins further pairs."""
    n = len(lin)
    if n == 0:
        return np.zeros(0, np.int64)
    us, vs = [], []
    right = np.nonzero((np.diff(lin) == 1) & ((lin[1:] % width) != 0))[0]
    us.append(right)
    vs.append(right + 1)
    j = np.searchsorted(lin, lin + width)
    ok = j < n
    ok[ok] = lin[j[ok]] == lin[ok] + width
    us.append(np.nonzero(ok)[0])
    vs.append(j[ok])
    for u, v in extra_edges:
        us.append(u)
        vs.append(v)
    u, v = np.concatenate(us), np.concatenate(vs)
    graph = coo_matrix((np.ones(len(u), np.int8), (u, v)), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    first = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(first, comp, np.arange(n))
    rank = np.empty_like(first)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    return rank[comp]


def spot_stats(label, x, y, z, value, fdt):
    """Per-spot pixels, counts, centroids (+0.5) and peaks (ties to the first pixel)."""
    s = int(label.max()) + 1 if len(label) else 0
    w = value.astype(np.int64)
    n_px = np.bincount(label, minlength=s)
    tot = np.bincount(label, weights=w, minlength=s).astype(fdt)
    com = [(np.bincount(label, weights=w * c, minlength=s).astype(fdt) / tot + fdt(0.5))
           for c in (x, y, z)]
    order = np.lexsort((np.arange(len(label)), -w, label))
    first = order[np.searchsorted(label[order], np.arange(s))]
    peak = [c[first] for c in (x, y, z)]
    return n_px, com, peak


def keep_mask(n_px, com, peak, min_size: int, max_sep: float) -> tuple[np.ndarray, np.ndarray]:
    """(size filter, size and separation filters)."""
    size_ok = n_px >= min_size if min_size > 0 else np.ones(len(n_px), bool)
    d = [p + 0.5 - c for p, c in zip(peak, com)]
    sep = np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    sep_ok = sep <= max_sep if max_sep > 0 else np.ones(len(n_px), bool)
    return size_ok, size_ok & sep_ok


def frame_spots(strong: torch.Tensor, image: torch.Tensor, sf: dict, fdt) -> FrameSpots:
    """A frame's strong mask and counts -> its strong pixels and 2D spots,
    the centroids in the NumPy float type ``fdt``."""
    h, w = strong.shape
    lin = torch.nonzero(strong.reshape(-1)).reshape(-1)
    value = pixel_values(image).reshape(-1)[lin].cpu().numpy()
    lin = lin.cpu().numpy()
    label = label_pixels(lin, w)
    n_px, com, peak = spot_stats(label, lin % w, lin // w, np.zeros(len(lin), np.int64), value, fdt)
    size_ok, both = keep_mask(n_px, com, peak, sf["min_spot_size"],
                              sf["max_peak_centroid_separation"])
    centers = np.stack([c[both] for c in com], axis=1)
    return FrameSpots(lin, value, int(size_ok.sum()), centers)


def frames_spots(frames: torch.Tensor, mask: np.ndarray, config: dict, precision: str,
                 blobs, fdt=np.float64) -> dict[int, FrameSpots]:
    """The 2D result of each distinct frame in ``blobs``: the threshold in
    ``precision``, the spot tables in ``fdt``."""
    det, sf = config["detector"], config["spotfinder"]
    algo = ALGORITHMS[sf["algorithm"]]
    dm = torch.from_numpy(mask).to(frames.device)
    out = {}
    for k in sorted(blobs):
        strong = algo(frames[k], dm, float(det["trusted_max"]), DTYPES[precision])
        out[k] = frame_spots(strong, frames[k], sf, fdt)
    return out


# ---------------------------------------------------------------- rotation


def rotation_table(sequence: list[FrameSpots], config: dict, fdt=np.float64) -> dict:
    """The 3D spot table of a frame sequence (frame z = its place in it), in
    the NumPy float type ``fdt``: {"xyzobs.px.value", "sigma_b_variance",
    "sigma_m_variance", "spot_extent_z"}."""
    det, geo, sf = config["detector"], config["geometry"], config["spotfinder"]
    w = det["width"]
    offs = np.cumsum([0] + [len(f.lin) for f in sequence])
    lin = np.concatenate([f.lin for f in sequence]) if sequence else np.zeros(0, np.int64)
    value = np.concatenate([f.value for f in sequence]) if sequence else np.zeros(0, np.int64)
    z = np.repeat(np.arange(len(sequence)), np.diff(offs))
    # nodes are (frame, pixel); intra-frame 4-neighbours and the same pixel in
    # the next frame are edges.  A global index z * H * W + lin keeps every
    # frame's pixels sorted; a pixel's right / down neighbours stay in its frame
    plane = det["height"] * w
    gl = z * plane + lin
    edges_u, edges_v = [], []
    for i in range(len(sequence) - 1):
        a, b = sequence[i].lin, sequence[i + 1].lin
        _, ia, ib = np.intersect1d(a, b, assume_unique=True, return_indices=True)
        edges_u.append(offs[i] + ia)
        edges_v.append(offs[i + 1] + ib)
    label = label_pixels(gl, w, [(np.concatenate(edges_u), np.concatenate(edges_v))]
                         if edges_u else ())
    x, y = lin % w, lin // w
    n_px, com, peak = spot_stats(label, x, y, z, value, fdt)
    _, keep = keep_mask(n_px, com, peak, sf["min_spot_size_3d"],
                        sf["max_peak_centroid_separation"])
    s = len(n_px)
    zmin = np.full(s, np.iinfo(np.int64).max)
    zmax = np.full(s, -1)
    np.minimum.at(zmin, label, z)
    np.maximum.at(zmax, label, z)

    # variances in Kabsch space (flat panel: fast = +x, slow = -y, beam -z)
    px = fdt(det["pixel_size_mm"])
    bx, by = geo["beam_center_px"]
    origin = np.array([-bx * px, by * px, -geo["distance_mm"]], fdt)

    def lab(xp, yp):
        return np.stack([origin[0] + xp * px, origin[1] - yp * px,
                         np.full(len(xp), origin[2], fdt)], axis=1).astype(fdt)

    s0 = np.array([0.0, 0.0, -1.0 / geo["wavelength_A"]], fdt)
    m2 = np.array([1.0, 0.0, 0.0], fdt)
    s1 = lab(com[0], com[1])
    e1 = np.cross(s1, s0)
    e1 /= np.linalg.norm(e1, axis=-1, keepdims=True)
    e2 = np.cross(s1, e1)
    e2 /= np.linalg.norm(e2, axis=-1, keepdims=True)
    mags1 = np.linalg.norm(s1, axis=-1)
    zeta = e1 @ m2
    start, width = fdt(geo["omega_start_deg"]), fdt(geo["omega_increment_deg"])
    phi = np.deg2rad(start + (com[2] - 1) * width)
    s1p = lab(x.astype(fdt) + fdt(0.5), y.astype(fdt) + fdt(0.5))
    delta = s1p - s1[label]
    eps1 = np.einsum("ij,ij->i", delta, e1[label]) / mags1[label]
    eps2 = np.einsum("ij,ij->i", delta, e2[label]) / mags1[label]
    eps3 = (np.deg2rad(start + (z.astype(fdt) + fdt(0.5) - 1) * width) - phi[label]) * zeta[label]
    wt = value.astype(fdt)
    tot = np.bincount(label, weights=wt, minlength=s).astype(fdt)
    var = [np.bincount(label, weights=wt * e * e, minlength=s).astype(fdt) / tot
           for e in (eps1, eps2, eps3)]
    return {
        "xyzobs.px.value": np.stack([c[keep] for c in com], axis=1),
        "sigma_b_variance": ((var[0] + var[1]) / 2)[keep],
        "sigma_m_variance": var[2][keep],
        "spot_extent_z": (zmax - zmin + 1)[keep],
    }
