"""Flood fill of the FFT grid with periodic wrap.

Equivalent of the reference flood_fill (reference:
baseline/indexer/flood_fill.cc:31-192): binarise at rmsd_cutoff * rmsd,
6-connected components *with wraparound in all three dimensions*, unweighted
fractional centres of mass, then the IQR/peak-volume filter.  Implemented as
vectorised scipy labelling plus a union-find merge of the periodic faces —
deterministic, unlike the reference's unordered_map traversal order (the
final peak set is identical).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

_S6 = np.zeros((3, 3, 3), dtype=int)
_S6[1, 1, 1] = _S6[0, 1, 1] = _S6[2, 1, 1] = 1
_S6[1, 0, 1] = _S6[1, 2, 1] = _S6[1, 1, 0] = _S6[1, 1, 2] = 1


def flood_fill(
    grid: np.ndarray,
    rmsd_cutoff: float = 15.0,
    n_points: int = 256,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (grid_points_per_void (V,), centres_of_mass_frac (V, 3)).

    COM order is (axis0, axis1, axis2) of the grid, i.e. the same (vx, vy,
    vz) fractional order the reference returns (flood_fill.cc:139-148 maps
    its z,y,x loop order back to vx,vy,vz).
    """
    grid = np.asarray(grid, dtype=np.float64).reshape(n_points, n_points, n_points)
    mean = grid.mean()
    rmsd = np.sqrt(np.mean((grid - mean) ** 2))
    binary = grid >= rmsd_cutoff * rmsd

    labels, n_labels = ndimage.label(binary, structure=_S6)
    if n_labels == 0:
        return np.zeros(0, dtype=np.int64), np.zeros((0, 3))

    # merge labels across the periodic boundaries (flood_fill.cc:60-63 note)
    parent = np.arange(n_labels + 1)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    for axis in range(3):
        lo = np.take(labels, 0, axis=axis).ravel()
        hi = np.take(labels, n_points - 1, axis=axis).ravel()
        both = (lo > 0) & (hi > 0)
        for a, b in set(zip(lo[both].tolist(), hi[both].tolist())):
            union(a, b)

    roots = np.array([find(i) for i in range(n_labels + 1)])
    merged = roots[labels]

    uniq = np.unique(merged[merged > 0])
    remap = np.zeros(n_labels + 1, dtype=np.int64)
    remap[uniq] = np.arange(len(uniq))
    lab = remap[merged]

    coords = np.argwhere(binary)  # (M, 3) in grid axis order
    lab_pts = lab[binary]
    n_voids = len(uniq)
    counts = np.bincount(lab_pts, minlength=n_voids)

    # Unwrap coordinates for components crossing the periodic boundary: use
    # each component's first point as reference, displacements wrapped into
    # (-n/2, n/2].  Known limitation vs the reference's BFS accumulation
    # (flood_fill.cc stack fill, which unwraps by neighbour chaining): a
    # component whose true extent reaches n/2 along an axis mis-unwraps.
    # Such half-grid components only arise on degenerate FFTs (a smeared
    # threshold region, not a lattice peak) and never survive the
    # peaks_to_rlvs d*/volume filters as basis candidates.
    ref_idx = np.zeros(n_voids, dtype=np.int64)
    seen = np.full(n_voids, False)
    for i, l in enumerate(lab_pts):
        if not seen[l]:
            seen[l] = True
            ref_idx[l] = i
    ref = coords[ref_idx[lab_pts]]
    delta = coords - ref
    delta = (delta + n_points // 2) % n_points - n_points // 2
    com = np.zeros((n_voids, 3))
    for ax in range(3):
        com[:, ax] = (
            np.bincount(lab_pts, weights=delta[:, ax], minlength=n_voids) / counts
            + coords[ref_idx][:, ax]
        )
    com_frac = com / n_points
    return counts, com_frac


def flood_fill_filter(
    grid_points_per_void: np.ndarray,
    centres_of_mass_frac: np.ndarray,
    peak_volume_cutoff: float = 0.15,
) -> tuple[np.ndarray, np.ndarray]:
    """IQR x5 high-volume rejection then peak_volume_cutoff * max filter
    (reference: flood_fill.cc:158-192).  High-volume peaks survive the
    filter; only small peaks are removed."""
    vols = np.asarray(grid_points_per_void)
    if len(vols) == 0:
        return vols, centres_of_mass_frac
    svols = np.sort(vols)
    q3 = svols[len(svols) * 3 // 4]
    q1 = svols[len(svols) // 4]
    cut = (q3 - q1) * 5 + q3
    trimmed = svols[svols <= cut]
    max_val = trimmed[-1] if len(trimmed) else svols[-1]
    peak_cutoff = int(peak_volume_cutoff * max_val)
    keep = vols > peak_cutoff
    return vols[keep], np.asarray(centres_of_mass_frac)[keep]
