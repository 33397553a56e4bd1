"""Pre-refinement reflection selection.

Equivalent of the reference reflection_filter (reference:
baseline/indexer/reflection_filter.cc): initial flag/spindle filtering,
Tukey x3-IQR outlier rejection on (x, y, phi) residuals, and the
deterministic mt19937 random subsample.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.reflection_table import (
    CENTROID_OUTLIER,
    PREDICTED,
    USED_IN_REFINEMENT,
)
from ..utils.mt19937 import random_selection
from .predict import predict_scan_static

OVERLOADED = 1 << 10
IQR_MULTIPLIER = 3.0


@dataclass
class Selection:
    """Pre-refinement observation subset (plain arrays)."""

    hkl: np.ndarray
    entering: np.ndarray
    xyzobs_mm: np.ndarray
    s1: np.ndarray
    flags: np.ndarray
    indices: np.ndarray  # indices into the parent table


def _quartiles(v: np.ndarray) -> tuple[float, float]:
    """Q1/Q3 via the reference's median-of-halves convention
    (reflection_filter.cc:66-97)."""
    v = np.sort(v)
    n = len(v)
    upper_start = n // 2
    n_lower = (n // 2) + 1 if n % 2 else n // 2
    if n_lower % 2:
        q1 = v[n_lower // 2]
        q3 = v[upper_start + n_lower // 2]
    else:
        q1 = (v[n_lower // 2] + v[n_lower // 2 - 1]) / 2
        q3 = (v[upper_start + n_lower // 2] + v[upper_start + n_lower // 2 - 1]) / 2
    return float(q1), float(q3)


def simple_tukey_outliers(xr, yr, zr) -> np.ndarray:
    """Bool mask of outliers (True = outlier), x3 IQR in any dimension."""
    out = np.zeros(len(xr), dtype=bool)
    if len(xr) == 0:
        # a candidate can lose every reflection to the spindle/validity
        # cuts before outlier rejection; no residuals -> no outliers
        # (the caller then drops the candidate on its min-count gate)
        return out
    for r in (xr, yr, zr):
        q1, q3 = _quartiles(r)
        iqr = q3 - q1
        out |= (r > q3 + IQR_MULTIPLIER * iqr) | (r < q1 - IQR_MULTIPLIER * iqr)
    return out


def reflection_filter_preevaluation(
    *,
    hkl: np.ndarray,
    flags: np.ndarray,
    s1: np.ndarray,
    xyzobs_mm: np.ndarray,
    entering: np.ndarray,
    crystal,
    beam,
    panel,
    gonio,
    scan_width_degrees: float,
    n_ref_per_degree: int = 100,
    close_to_spindle_cutoff: float = 0.02,
    min_sample_size: int = 1000,
    max_sample_size: int = 0,
) -> Selection:
    """Initial filter -> predict -> Tukey outlier filter -> subsample."""
    flags = np.asarray(flags, dtype=np.uint64)
    s0 = beam.s0
    axis = gonio.rotation_axis

    # initial filter (reflection_filter.cc:193-240)
    sel = np.ones(len(hkl), dtype=bool)
    sel &= (flags & OVERLOADED) != OVERLOADED
    sel &= ~(np.asarray(hkl) == 0).all(axis=1)
    sel &= np.abs(np.cross(s1, s0) @ axis) > close_to_spindle_cutoff
    idx = np.nonzero(sel)[0]

    # predict and reject Tukey outliers on residuals
    d_matrix = np.stack([panel.fast_axis, panel.slow_axis, panel.origin], axis=1)
    pred = predict_scan_static(
        hkl[idx],
        entering[idx],
        xyzobs_mm[idx, 2],
        s0=s0,
        fixed_rotation=gonio.fixed_rotation,
        setting_rotation=gonio.setting_rotation,
        rotation_axis=gonio.rotation_axis,
        ub=crystal.a_matrix,
        d_matrix=d_matrix,
    )
    predicted = pred["valid"]
    idx = idx[predicted]
    resid = pred["xyzcal_mm"][predicted] - xyzobs_mm[idx]
    outliers = simple_tukey_outliers(resid[:, 0], resid[:, 1], resid[:, 2])
    idx = idx[~outliers]

    new_flags = flags[idx] | USED_IN_REFINEMENT
    new_flags &= ~np.uint64(CENTROID_OUTLIER)

    # deterministic subsample (reflection_filter.cc:242-268).
    # std::round rounds half AWAY from zero; Python round() is banker's
    # (round(50.5) == 50) which would change sample_size for half-degree
    # scan widths and hence the bit-for-bit mt19937 subsample
    sample_size = int(
        n_ref_per_degree * max(int(np.floor(scan_width_degrees + 0.5)), 1)
    )
    sample_size = max(sample_size, min_sample_size)
    if max_sample_size:
        sample_size = min(sample_size, max_sample_size)
    if sample_size < len(idx):
        pick = random_selection(len(idx), sample_size)
        idx = idx[pick]
        new_flags = new_flags[pick]

    return Selection(
        hkl=np.asarray(hkl)[idx],
        entering=np.asarray(entering)[idx],
        xyzobs_mm=np.asarray(xyzobs_mm)[idx],
        s1=np.asarray(s1)[idx],
        flags=new_flags,
        indices=idx,
    )
