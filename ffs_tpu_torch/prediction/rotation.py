"""Rotation-series spot prediction on a torch device.

Counterpart of :mod:`ffs_tpu.prediction.rotation` (reference:
src/predictor/predict.cc:31-211 with the scan-varying ray predictor
ray_predictors.cc:115-201): the full resolution-limited hkl grid is made
once on the host, and for every image the closed-form Ewald-crossing test of
every hkl runs as one batch of float64 tensor operations on the device.
The rays that cross are brought to the host, where the panel intersection
and the on-panel test run (NumPy, on a few hundred rows per image).

The JAX package's device path (an f32 wide-band scan, then an f64
re-evaluation of the candidates) exists because the TPU emulates float64.
The H100 has native float64, so the port runs the pure-f64 search of
``predict_rotation(..., use_device=False)``: the same hkl set in the same
order, with the same rays to float64 rounding.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.reflection_table import PREDICTED
from ..utils.exact import sum3


@dataclass
class ScanVaryingData:
    """Per-scan-point model states parsed from the expt JSON
    (reference: predict.cc:213-275)."""

    s0_at_scan_points: np.ndarray | None = None  # (n_img+1, 3)
    a_at_scan_points: np.ndarray | None = None  # (n_img+1, 3, 3)
    setting_at_scan_points: np.ndarray | None = None  # (n_img+1, 3, 3)

    def __bool__(self):
        return any(
            v is not None
            for v in (
                self.s0_at_scan_points,
                self.a_at_scan_points,
                self.setting_at_scan_points,
            )
        )


def hkl_grid(a_matrix: np.ndarray, dmin: float, group_ops=None) -> np.ndarray:
    """All hkl with |h| <= |a|/dmin etc. (excluding 000), conservative
    per-axis loop bounds from the direct cell lengths.

    ``group_ops`` (models/symmetry.GroupOps) drops systematically-absent
    indices — the reference builds its generators with the crystal's
    space-group operations and filters inside the enumeration
    (predict.cc:156-157, index_generators.hpp:83,462)."""
    direct = np.linalg.inv(a_matrix)  # rows = real-space vectors
    lengths = np.linalg.norm(direct, axis=1)
    hmax = np.ceil(lengths / dmin).astype(int)
    hs = np.arange(-hmax[0], hmax[0] + 1)
    ks = np.arange(-hmax[1], hmax[1] + 1)
    ls = np.arange(-hmax[2], hmax[2] + 1)
    grid = np.stack(np.meshgrid(hs, ks, ls, indexing="ij"), axis=-1).reshape(-1, 3)
    grid = grid[~(grid == 0).all(axis=1)]
    if group_ops is not None:
        grid = grid[~group_ops.is_systematically_absent(grid)]
    return grid


def _rays_for_image(h, a1, a2, s0_1, s0_2, dmin, phi_beg, d_osc):
    """Torch form of the JAX package's ``_rays_for_image``, the vectorised
    predict_ray_monochromatic_sv (ray_predictors.cc:115-201), in float64.

    ``h`` (N, 3) float64 hkl on the device; ``a1``/``a2`` the 3x3 setting
    matrices and ``s0_1``/``s0_2`` the beam vectors at the image's start and
    end, as NumPy arrays.  The beam's norms, unit vectors and wavenumber are
    host scalars from NumPy, as in the JAX package's host path.  Returns
    (valid, s1, angle, entering)."""
    dev = h.device

    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64), device=dev)

    r1 = h @ t(a1).T
    r2 = h @ t(a2).T
    dr = r2 - r1
    s0_1t, s0_2t = t(s0_1), t(s0_2)
    s0pr1 = s0_1t + r1
    s0pr2 = s0_2t + r2

    n01 = float(np.linalg.norm(s0_1))
    n02 = float(np.linalg.norm(s0_2))
    r1_from_es = torch.sqrt(sum3(s0pr1 * s0pr1)) - n01
    r2_from_es = torch.sqrt(sum3(s0pr2 * s0pr2)) - n02
    starts_outside = r1_from_es >= 0.0
    ends_outside = r2_from_es >= 0.0
    r1_sq = sum3(r1 * r1)
    ok = (starts_outside != ends_outside) & (r1_sq <= 1.0 / (dmin * dmin))

    a = sum3(dr * dr)
    a_safe = torch.where(a == 0, torch.ones_like(a), a)
    nan = torch.full_like(a, float("nan"))

    def root_in_01(b, c):
        d = b * b - a_safe * c
        ok_d = d >= 0
        sq = torch.sqrt(torch.clamp_min(d, 0.0))
        lo = (-b - sq) / a_safe
        hi = (-b + sq) / a_safe
        lo_ok = (lo >= 0.0) & (lo <= 1.0)
        hi_ok = (hi >= 0.0) & (hi <= 1.0)
        alpha = torch.where(lo_ok, lo, torch.where(hi_ok, hi, nan))
        return ok_d & (lo_ok | hi_ok), alpha

    ok1, alpha1 = root_in_01(
        sum3(s0pr1 * dr),
        r1_sq + 2 * (r1 @ s0_1t),
    )
    ok2, alpha2 = root_in_01(
        -sum3(s0pr2 * dr),
        sum3(r2 * r2) + 2 * (r2 @ s0_2t),
    )
    ok = ok & ok1 & ok2 & (a > 0)

    denom = alpha1 + alpha2
    alpha = torch.where(ok, alpha1, torch.full_like(a, 0.5)) / torch.where(
        ok, denom, torch.ones_like(a)
    )
    us0_1 = np.asarray(s0_1) / n01
    us0_2 = np.asarray(s0_2) / n02
    us0 = alpha[:, None] * t(us0_2 - us0_1) + t(us0_1)
    wavenumber = (n01 + n02) * 0.5
    s1 = r1 + alpha[:, None] * dr + wavenumber * us0
    angle = phi_beg + alpha * d_osc
    return ok, s1, angle, starts_outside


@dataclass
class PredictedReflections:
    hkl: np.ndarray
    s1: np.ndarray
    xyzcal_px: np.ndarray
    xyzcal_mm: np.ndarray
    panel: np.ndarray
    entering: np.ndarray
    flags: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.uint64))


def _rotation_matrix(m2: np.ndarray, angle_deg: float) -> np.ndarray:
    t = np.deg2rad(angle_deg)
    c, s = np.cos(t), np.sin(t)
    x, y, z = m2
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return c * np.eye(3) + s * K + (1 - c) * np.outer(m2, m2)


def predict_rotation(
    experiment,
    sv_data: ScanVaryingData | None = None,
    dmin: float | None = None,
    *,
    device: torch.device | None = None,
    chunk: int = 1 << 20,
) -> PredictedReflections:
    """Predict all reflections over the scan (reference: predict.cc:130-211).

    The ray search runs on ``device`` (by default the CUDA device, or the
    CPU under ``FFS_TORCH_DEVICE=cpu``) over ``chunk`` hkl rows at a time.
    """
    if device is None:
        from ..utils.torchinit import select_device

        device = select_device()
    sv = sv_data or ScanVaryingData()
    scan = experiment.scan
    beam = experiment.beam
    gonio = experiment.goniometer
    panel = experiment.panel
    crystal = experiment.crystal

    if dmin is None:
        # detector-corner resolution limit
        w, h = panel.image_size
        corners_px = np.array([[0, 0], [w, 0], [0, h], [w, h]], dtype=float)
        xmm, ymm = panel.px_to_mm(corners_px[:, 0], corners_px[:, 1])
        lab = panel.get_lab_coord(xmm, ymm)
        s1_dir = lab / np.linalg.norm(lab, axis=1, keepdims=True)
        s0 = beam.s0
        # d = 1/|rlp| at the corners, rlp = s1 - s0 (s0 already points
        # source -> sample with |s0| = 1/lambda)
        d = 1.0 / np.linalg.norm(s1_dir / beam.wavelength - s0, axis=1)
        dmin = float(d.min())

    m2 = gonio.rotation_axis / np.linalg.norm(gonio.rotation_axis)
    r_fixed = gonio.fixed_rotation
    r_setting = gonio.setting_rotation
    osc0, d_osc = scan.oscillation
    z0 = scan.image_range[0] - 1
    n_images = scan.image_range[1] - scan.image_range[0] + 1
    A = crystal.a_matrix
    s0 = beam.s0

    from ..models.symmetry import group_ops_from_symbol

    hkl = hkl_grid(A, dmin, group_ops=group_ops_from_symbol(crystal.space_group))
    hkl_dev = torch.from_numpy(hkl.astype(np.float64)).to(device)
    w, hh = panel.image_size
    # on-panel bounds in mm, matching dx2 Panel::get_ray_intersection (the
    # parallax-corrected px can land fractionally outside [0, size_px) for
    # a ray inside the physical panel)
    wmm = w * panel.pixel_size[0]
    hmm = hh * panel.pixel_size[1]

    out_hkl, out_s1, out_px, out_mm, out_panel, out_entering = ([], [], [], [], [], [])
    for image_index in range(n_images):
        s0_1 = s0 if sv.s0_at_scan_points is None else sv.s0_at_scan_points[image_index]
        s0_2 = s0 if sv.s0_at_scan_points is None else sv.s0_at_scan_points[image_index + 1]
        A1 = A if sv.a_at_scan_points is None else sv.a_at_scan_points[image_index]
        A2 = A if sv.a_at_scan_points is None else sv.a_at_scan_points[image_index + 1]
        rs1 = (
            r_setting
            if sv.setting_at_scan_points is None
            else sv.setting_at_scan_points[image_index]
        )
        rs2 = (
            r_setting
            if sv.setting_at_scan_points is None
            else sv.setting_at_scan_points[image_index + 1]
        )
        phi_beg = osc0 + image_index * d_osc
        phi_end = phi_beg + d_osc
        A1_full = rs1 @ _rotation_matrix(m2, phi_beg) @ r_fixed @ A1
        A2_full = rs2 @ _rotation_matrix(m2, phi_end) @ r_fixed @ A2

        for c0 in range(0, len(hkl), chunk):
            ok, s1, angle, entering = _rays_for_image(
                hkl_dev[c0 : c0 + chunk], A1_full, A2_full,
                np.asarray(s0_1, dtype=np.float64), np.asarray(s0_2, dtype=np.float64),
                dmin, phi_beg, d_osc,
            )
            idx_dev = torch.nonzero(ok).flatten()
            if not len(idx_dev):
                continue
            idx = idx_dev.cpu().numpy() + c0
            s1_sel = s1[idx_dev].cpu().numpy()
            ang = angle[idx_dev].cpu().numpy()
            ent = entering[idx_dev].cpu().numpy()
            xmm, ymm = panel.get_ray_intersection(s1_sel)
            x_px, y_px = panel.mm_to_px(xmm, ymm)
            on_panel = (xmm >= 0) & (xmm < wmm) & (ymm >= 0) & (ymm < hmm)
            if not on_panel.any():
                continue
            frame = z0 + (ang[on_panel] - osc0) / d_osc
            out_hkl.append(hkl[idx[on_panel]])
            out_s1.append(s1_sel[on_panel])
            out_px.append(np.stack([x_px[on_panel], y_px[on_panel], frame], axis=1))
            out_mm.append(
                np.stack([xmm[on_panel], ymm[on_panel], np.deg2rad(ang[on_panel])], axis=1)
            )
            out_panel.append(np.zeros(int(on_panel.sum()), dtype=np.uint64))
            out_entering.append(ent[on_panel])

    if not out_hkl:
        empty3 = np.zeros((0, 3))
        return PredictedReflections(
            hkl=np.zeros((0, 3), np.int64),
            s1=empty3,
            xyzcal_px=empty3,
            xyzcal_mm=empty3,
            panel=np.zeros(0, np.uint64),
            entering=np.zeros(0, bool),
            flags=np.zeros(0, np.uint64),
        )
    hkl_all = np.concatenate(out_hkl)
    return PredictedReflections(
        hkl=hkl_all,
        s1=np.concatenate(out_s1),
        xyzcal_px=np.concatenate(out_px),
        xyzcal_mm=np.concatenate(out_mm),
        panel=np.concatenate(out_panel),
        entering=np.concatenate(out_entering),
        flags=np.full(len(hkl_all), PREDICTED, dtype=np.uint64),
    )


def parse_scan_varying(elist: dict, n_images: int) -> ScanVaryingData:
    """Extract scan-varying model arrays from an expt JSON
    (reference: predict.cc:213-275)."""
    sv = ScanVaryingData()
    crystal = (elist.get("crystal") or [{}])[0]
    if "A_at_scan_points" in crystal:
        arr = np.asarray(crystal["A_at_scan_points"], dtype=float)
        if len(arr) == n_images + 1:
            sv.a_at_scan_points = arr.reshape(-1, 3, 3)
    beam = (elist.get("beam") or [{}])[0]
    if "s0_at_scan_points" in beam:
        arr = np.asarray(beam["s0_at_scan_points"], dtype=float)
        if len(arr) == n_images + 1:
            sv.s0_at_scan_points = arr.reshape(-1, 3)
    gonio = (elist.get("goniometer") or [{}])[0]
    if "setting_rotation_at_scan_points" in gonio:
        arr = np.asarray(gonio["setting_rotation_at_scan_points"], dtype=float)
        if len(arr) == n_images + 1:
            sv.setting_at_scan_points = arr.reshape(-1, 3, 3)
    return sv
