"""Independent CPU oracle for the Kabsch classification/accumulation step.

This is the TPU repo's analogue of the reference's CPU ``baseline_integrator``
(reference: baseline/integrator — the independently-written CPU implementation
the GPU Kabsch kernel is validated against, integrator.cc:1030-1096): a plain
NumPy f64 implementation of the same *specification* (kabsch.cu:60-675) that
shares no code with :mod:`ffs_tpu.integration.kabsch`'s device path.  Where
the production path precomputes a detector-wide corner field, splits it into
hi/lo f32 planes, gathers shoebox windows by DMA and evaluates the ellipsoid
via f32 einsums with exact-integer sum decompositions and an MXU one-hot
histogram, this oracle walks every (reflection, frame, pixel, corner)
directly in f64:

- corner scattered wavevector from the panel geometry (with parallax
  correction) computed inline per corner (kabsch.cu:174-258);
- Kabsch-frame projections eps1/eps2 against e1/e2/|s1| and the ellipsoid
  test at the frame's phi_low / phi_high (and phi_c when inside the slice)
  (kabsch.cu:336-380);
- pixel foreground = OR of its four voxel corners;
- foreground intensity/centroid-moment accumulation and the bounded
  256-bin background histogram with overflow (kabsch.cu:585-650).

tests/test_kabsch_oracle.py drives the production blocked device step and
this oracle over the same synthetic collection and asserts exact agreement
(classification counts, histograms and integer-exact sums; centroid moments
at f64 round-off).
"""

from __future__ import annotations

import numpy as np

from .background import NUM_BG_BINS


def corner_s_vector(panel, cx: np.ndarray, cy: np.ndarray, wavelength: float):
    """Scattered wavevector (|s| = 1/lambda) at pixel-corner coordinates.

    Direct f64 evaluation including the parallax px->mm correction
    (kabsch.cu:174-258; dx2 parallax px_to_mm).  ``cx``/``cy`` are corner
    indices (pixel units)."""
    fast = np.asarray(panel.fast_axis, dtype=np.float64)
    slow = np.asarray(panel.slow_axis, dtype=np.float64)
    origin = np.asarray(panel.origin, dtype=np.float64)
    x1 = np.asarray(cx, dtype=np.float64) * float(panel.pixel_size[0])
    x2 = np.asarray(cy, dtype=np.float64) * float(panel.pixel_size[1])
    if bool(panel.parallax and panel.mu > 0):
        mu, t0 = float(panel.mu), float(panel.thickness)
        normal = np.cross(fast, slow)
        if np.dot(origin, normal) < 0:
            normal = -normal
        normal = normal / np.linalg.norm(normal)
        lab0 = origin + x1[..., None] * fast + x2[..., None] * slow
        s1_hat = lab0 / np.linalg.norm(lab0, axis=-1, keepdims=True)
        cos_t = s1_hat @ normal
        o = (1.0 / mu) - (t0 / cos_t + 1.0 / mu) * np.exp(-mu * t0 / cos_t)
        x1 = x1 - (s1_hat @ fast) * o
        x2 = x2 - (s1_hat @ slow) * o
    lab = origin + x1[..., None] * fast + x2[..., None] * slow
    return lab / np.linalg.norm(lab, axis=-1, keepdims=True) / float(wavelength)


def integrate_reference(
    frames: np.ndarray,  # (F, H, W) raw counts
    det_mask,  # (H, W) nonzero = valid, or None
    bboxes: np.ndarray,  # (N, 6) x0,x1,y0,y1,z0,z1 (x/y inclusive, z exclusive hi)
    s1: np.ndarray,  # (N, 3) predicted diffracted beam vectors
    phi: np.ndarray,  # (N,) predicted phi (radians)
    s0: np.ndarray,
    rotation_axis: np.ndarray,
    panel,
    wavelength: float,
    phi_lows: np.ndarray,  # (F,) phi at each frame's start (radians)
    d_osc: float,  # oscillation width (radians)
    z_values: np.ndarray,  # (F,) frame numbers
    delta_b: float,
    delta_m: float,
    algorithm: str = "ellipsoid",
    centre_slices: bool = True,
):
    """Integrate ``frames`` for every reflection; returns a dict of
    per-reflection accumulators matching :class:`kabsch.Accumulators`."""
    frames = np.asarray(frames)
    n_ref = len(bboxes)
    h, w = frames.shape[1:]
    if det_mask is None:
        det_mask = np.ones((h, w), bool)
    det_mask = np.asarray(det_mask) != 0

    m2 = np.asarray(rotation_axis, dtype=np.float64)
    m2 = m2 / np.linalg.norm(m2)
    s0 = np.asarray(s0, dtype=np.float64)
    s1 = np.asarray(s1, dtype=np.float64)

    out = {
        "fg_sum": np.zeros(n_ref),
        "fg_count": np.zeros(n_ref, dtype=np.int64),
        "sum_ix": np.zeros(n_ref),
        "sum_iy": np.zeros(n_ref),
        "sum_iz": np.zeros(n_ref),
        "bg_hist": np.zeros((n_ref, NUM_BG_BINS), dtype=np.int64),
        "bg_overflow": np.zeros(n_ref, dtype=np.int64),
        "bg_count": np.zeros(n_ref, dtype=np.int64),
    }

    for i in range(n_ref):
        x_lo, x_hi, y_lo, y_hi, z_lo, z_hi = (int(v) for v in bboxes[i])
        x_hi = min(x_hi, w - 1)
        y_hi = min(y_hi, h - 1)
        if x_hi < x_lo or y_hi < y_lo:
            continue
        # Kabsch frame for this reflection (extent.cc coordinate_systems)
        e1 = np.cross(s1[i], s0)
        e1 = e1 / np.linalg.norm(e1)
        e2 = np.cross(s1[i], e1)
        e2 = e2 / np.linalg.norm(e2)
        zeta = float(e1 @ m2)
        s1_len = float(np.linalg.norm(s1[i]))

        # corner grid for the bbox: (ny+1, nx+1) corners
        cx = np.arange(x_lo, x_hi + 2, dtype=np.float64)
        cy = np.arange(y_lo, y_hi + 2, dtype=np.float64)
        gx, gy = np.meshgrid(cx, cy)
        s_px = corner_s_vector(panel, gx, gy, wavelength)
        delta = s_px - s1[i]
        eps1 = delta @ (e1 / s1_len)
        eps2 = delta @ (e2 / s1_len)
        e12 = (eps1 * eps1 + eps2 * eps2) / (delta_b * delta_b)

        def corner_in_at(phi_eval):
            if algorithm == "dials":
                return e12 <= 1.0
            eps3 = zeta * (phi_eval - phi[i])
            return e12 <= 1.0 - eps3 * eps3 / (delta_m * delta_m)

        mask_win = det_mask[y_lo : y_hi + 1, x_lo : x_hi + 1]
        xs = np.arange(x_lo, x_hi + 1, dtype=np.float64)
        ys = np.arange(y_lo, y_hi + 1, dtype=np.float64)

        for f in range(frames.shape[0]):
            z = float(z_values[f])
            if not (z_lo <= z < z_hi):
                continue
            phi_low = float(phi_lows[f])
            phi_high = phi_low + d_osc
            if algorithm == "dials":
                corner_in = corner_in_at(phi_low)
            else:
                corner_in = corner_in_at(phi_low) | corner_in_at(phi_high)
                if centre_slices and (
                    min(phi_low, phi_high)
                    <= phi[i]
                    <= max(phi_low, phi_high)
                ):
                    corner_in = corner_in | corner_in_at(phi[i])
            fg = (
                corner_in[:-1, :-1]
                | corner_in[:-1, 1:]
                | corner_in[1:, :-1]
                | corner_in[1:, 1:]
            )
            fg = fg & mask_win
            bg = (~fg) & mask_win

            ivals = np.maximum(
                frames[f, y_lo : y_hi + 1, x_lo : x_hi + 1].astype(np.int64),
                0,
            )
            out["fg_sum"][i] += float((ivals * fg).sum())
            out["fg_count"][i] += int(fg.sum())
            out["sum_ix"][i] += float(((ivals * fg) * (xs + 0.5)[None, :]).sum())
            out["sum_iy"][i] += float(((ivals * fg) * (ys + 0.5)[:, None]).sum())
            out["sum_iz"][i] += float((ivals * fg).sum() * (z + 0.5))
            bg_vals = ivals[bg]
            in_range = bg_vals < NUM_BG_BINS
            out["bg_hist"][i] += np.bincount(
                bg_vals[in_range], minlength=NUM_BG_BINS
            )
            out["bg_overflow"][i] += int((~in_range).sum())
            out["bg_count"][i] += int(bg.sum())

    return out
