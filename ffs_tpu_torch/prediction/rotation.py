"""Rotation-series spot prediction on a torch device.

Counterpart of :mod:`ffs_tpu.prediction.rotation` (reference:
src/predictor/predict.cc:31-211 with the scan-varying ray predictor
ray_predictors.cc:115-201).  The full resolution-limited hkl grid is made
once on the host; the closed-form Ewald-crossing test of every (image, hkl)
pair runs on the device.

``predict_rotation`` defaults, as the JAX package's does, to the blocked
two-pass search (``use_device=True``): for a block of 32 images, pass 1
screens every pair in float32 inside a widened band, the survivors are
compacted on the device per hkl chunk and merged into one fixed-capacity
set, and pass 2 re-evaluates them with the exact float64 predicate and ray
maths.  A block is one upload and one download: the host reads one packed
result (rows and candidate counts), re-runs the block at a larger capacity
if a count overflowed, and intersects the rays with the panel (NumPy).  Its
rows come in the JAX default's order: block, hkl chunk, image, hkl.

``use_device=False`` keeps the per-image float64 search (JAX's
``use_device=False`` form): for each image every hkl chunk runs as one batch
of float64 tensor operations.  Both give the same rays; only the row order
differs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.reflection_table import PREDICTED
from ..utils.exact import fma_sum3, sqrt_rn, sum3


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


def _no_reflections() -> PredictedReflections:
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


def _rotation_matrix(m2: np.ndarray, angle_deg: float) -> np.ndarray:
    t = np.deg2rad(angle_deg)
    c, s = np.cos(t), np.sin(t)
    x, y, z = m2
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return c * np.eye(3) + s * K + (1 - c) * np.outer(m2, m2)


def _image_states(experiment, sv: ScanVaryingData, n_images: int, osc0: float, d_osc: float):
    """Per-image model states on the host: the setting matrices at the
    image's start and end (A1, A2: (n, 3, 3)), the beams (s0_1, s0_2:
    (n, 3)) and the start angles in degrees (n,)."""
    gonio = experiment.goniometer
    m2 = gonio.rotation_axis / np.linalg.norm(gonio.rotation_axis)
    r_fixed, r_setting = gonio.fixed_rotation, gonio.setting_rotation
    A, s0 = experiment.crystal.a_matrix, experiment.beam.s0
    a1, a2 = np.empty((n_images, 3, 3)), np.empty((n_images, 3, 3))
    s01, s02 = np.empty((n_images, 3)), np.empty((n_images, 3))
    phis = np.empty(n_images)
    for i in range(n_images):
        s01[i] = s0 if sv.s0_at_scan_points is None else sv.s0_at_scan_points[i]
        s02[i] = s0 if sv.s0_at_scan_points is None else sv.s0_at_scan_points[i + 1]
        ai1 = A if sv.a_at_scan_points is None else sv.a_at_scan_points[i]
        ai2 = A if sv.a_at_scan_points is None else sv.a_at_scan_points[i + 1]
        rs1 = r_setting if sv.setting_at_scan_points is None else sv.setting_at_scan_points[i]
        rs2 = r_setting if sv.setting_at_scan_points is None else sv.setting_at_scan_points[i + 1]
        phis[i] = osc0 + i * d_osc
        a1[i] = rs1 @ _rotation_matrix(m2, phis[i]) @ r_fixed @ ai1
        a2[i] = rs2 @ _rotation_matrix(m2, phis[i] + d_osc) @ r_fixed @ ai2
    return a1, a2, s01, s02, phis


def _scan_grid(experiment, dmin: float | None):
    """(dmin, hkl grid): ``dmin`` or, where it is None, the resolution at
    the detector's corners; the grid without the space group's absences."""
    panel, beam = experiment.panel, experiment.beam
    if dmin is None:
        w, h = panel.image_size
        corners_px = np.array([[0, 0], [w, 0], [0, h], [w, h]], dtype=float)
        xmm, ymm = panel.px_to_mm(corners_px[:, 0], corners_px[:, 1])
        lab = panel.get_lab_coord(xmm, ymm)
        s1_dir = lab / np.linalg.norm(lab, axis=1, keepdims=True)
        # d = 1/|rlp| at the corners, rlp = s1 - s0 (s0 already points
        # source -> sample with |s0| = 1/lambda)
        d = 1.0 / np.linalg.norm(s1_dir / beam.wavelength - beam.s0, axis=1)
        dmin = float(d.min())
    from ..models.symmetry import group_ops_from_symbol

    crystal = experiment.crystal
    return dmin, hkl_grid(crystal.a_matrix, dmin,
                          group_ops=group_ops_from_symbol(crystal.space_group))


def predict_rotation(
    experiment,
    sv_data: ScanVaryingData | None = None,
    dmin: float | None = None,
    use_device: bool = True,
    chunk: int = 1 << 17,
    *,
    device: torch.device | None = None,
) -> PredictedReflections:
    """Predict all reflections over the scan (reference: predict.cc:130-211).

    Both searches run on ``device`` (by default the CUDA device, or the
    CPU under ``FFS_TORCH_DEVICE=cpu``) over ``chunk`` hkl rows at a time:
    the blocked two-pass search by default, the per-image float64 search
    with ``use_device=False``.  The blocked search's row order depends on
    ``chunk``.
    """
    if device is None:
        from ..utils.torchinit import select_device

        device = select_device()
    sv = sv_data or ScanVaryingData()
    scan = experiment.scan
    osc0, d_osc = scan.oscillation
    z0 = scan.image_range[0] - 1
    n_images = scan.image_range[1] - scan.image_range[0] + 1
    dmin, hkl = _scan_grid(experiment, dmin)
    if use_device:
        return _predict_rotation_device(experiment, sv, hkl, dmin, d_osc, osc0, z0, n_images,
                                        hkl_chunk=chunk, device=device)

    panel = experiment.panel
    hkl_dev = torch.from_numpy(hkl.astype(np.float64)).to(device)
    w, hh = panel.image_size
    # on-panel bounds in mm, matching dx2 Panel::get_ray_intersection (the
    # parallax-corrected px can land fractionally outside [0, size_px) for
    # a ray inside the physical panel)
    wmm = w * panel.pixel_size[0]
    hmm = hh * panel.pixel_size[1]

    out_hkl, out_s1, out_px, out_mm, out_panel, out_entering = ([], [], [], [], [], [])
    states = zip(*_image_states(experiment, sv, n_images, osc0, d_osc))
    for A1_full, A2_full, s0_1, s0_2, phi_beg in states:
        for c0 in range(0, len(hkl), chunk):
            ok, s1, angle, entering = _rays_for_image(
                hkl_dev[c0 : c0 + chunk], A1_full, A2_full, s0_1, s0_2, dmin, float(phi_beg),
                d_osc,
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
        return _no_reflections()
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


def _compact_i32(mask: torch.Tensor, cap: int):
    """Fixed-capacity compaction of the True positions of ``mask`` (1-D),
    ascending, with no host synchronisation (``torch.nonzero`` waits for
    the device to learn its size): slot i holds the position of the
    (i+1)-th True, found by a binary search of the int32 running count.
    Returns (idx (cap,) int32, valid (cap,) bool); invalid slots hold
    ``len(mask)``."""
    total = mask.shape[0]
    c = torch.cumsum(mask, 0, dtype=torch.int32)
    want = torch.arange(1, cap + 1, dtype=torch.int32, device=mask.device)
    idx = torch.searchsorted(c, want, side="left", out_int32=True)
    valid = want <= c[-1]
    return torch.where(valid, idx, total), valid


def _rays_rowwise(h, a1, a2, s0_1, s0_2, dmin, phi_beg, d_osc):
    """The exact float64 predicate and ray maths of :func:`_rays_for_image`
    with a matrix pair and a beam pair a row (``a1``, ``a2``: (n, 3, 3);
    ``s0_1``, ``s0_2``: (n, 3); ``phi_beg``: (n,)), in the JAX package's
    ``_rays_rowwise`` order, rounded as XLA's compiled block rounds it on
    the CPU: each product that it fuses into a sum is one ``addcmul`` (a
    fused multiply-add), as in the 3-term dots and reductions
    (:func:`fma_sum3`), the discriminants, s1 and the angle; the norms are
    plain sums of squares; square roots are correctly rounded
    (:func:`sqrt_rn`).  Returns (valid, s1, angle, entering)."""
    r1 = fma_sum3(h[:, None, :], a1)
    r2 = fma_sum3(h[:, None, :], a2)
    dr = r2 - r1
    s0pr1 = s0_1 + r1
    s0pr2 = s0_2 + r2
    n01 = sqrt_rn(sum3(s0_1 * s0_1))
    n02 = sqrt_rn(sum3(s0_2 * s0_2))
    starts_outside = sqrt_rn(sum3(s0pr1 * s0pr1)) - n01 >= 0.0
    ends_outside = sqrt_rn(sum3(s0pr2 * s0pr2)) - n02 >= 0.0
    r1_sq = fma_sum3(r1, r1)
    ok = (starts_outside != ends_outside) & (r1_sq <= 1.0 / (dmin * dmin))
    a = fma_sum3(dr, dr)
    a_safe = torch.where(a == 0, 1.0, a)

    def root_in_01(b, c):
        d = torch.addcmul(-(a_safe * c), b, b)
        ok_d = d >= 0
        sq = sqrt_rn(torch.clamp_min(d, 0.0))
        lo = (-b - sq) / a_safe
        hi = (-b + sq) / a_safe
        lo_ok = (lo >= 0.0) & (lo <= 1.0)
        hi_ok = (hi >= 0.0) & (hi <= 1.0)
        alpha = torch.where(lo_ok, lo, torch.where(hi_ok, hi, float("nan")))
        return ok_d & (lo_ok | hi_ok), alpha

    ok1, alpha1 = root_in_01(fma_sum3(s0pr1, dr), r1_sq + 2 * fma_sum3(r1, s0_1))
    ok2, alpha2 = root_in_01(-fma_sum3(s0pr2, dr), fma_sum3(r2, r2) + 2 * fma_sum3(r2, s0_2))
    ok = ok & ok1 & ok2 & (a > 0)
    denom = alpha1 + alpha2
    alpha = torch.where(ok, alpha1, 0.5) / torch.where(ok, denom, 1.0)
    us0_1 = s0_1 / n01[:, None]
    us0_2 = s0_2 / n02[:, None]
    us0 = torch.addcmul(us0_1, alpha[:, None], us0_2 - us0_1)
    wavenumber = (n01 + n02) * 0.5
    s1 = torch.addcmul(torch.addcmul(r1, alpha[:, None], dr), wavenumber[:, None], us0)
    angle = torch.addcmul(phi_beg, alpha, torch.tensor(d_osc, dtype=alpha.dtype,
                                                        device=alpha.device))
    return ok, s1, angle, starts_outside


def _default_chunk_cap(cap: int) -> int:
    return min(cap, max(4096, cap // 8))


def _overflowed(counts, cap: int, chunk_cap: int) -> bool:
    """Whether a block's [wide candidates, most in one chunk] overflowed
    its capacities."""
    return counts[0] > cap or counts[1] > chunk_cap


def _grown(counts, cap: int, chunk_cap: int) -> tuple[int, int]:
    """(cap, chunk_cap) after an overflow: only the capacity that
    overflowed grows (cap doubles; chunk_cap follows it, or doubles)."""
    if counts[0] > cap:
        cap *= 2
    chunk_cap = min(cap, max(chunk_cap, _default_chunk_cap(cap)))
    if counts[1] > chunk_cap:
        chunk_cap = min(cap, chunk_cap * 2)
    return cap, chunk_cap


# packed per-image columns: a1 (9) | a2 (9) | s0_1 (3) | s0_2 (3) | phi | live
PACKED_COLUMNS = 26


def _prediction_block(packed, tables, cap: int, chunk_cap: int, dmin: float, d_osc: float):
    """One block of the two-pass ray search, all on ``packed``'s device
    with no host synchronisation (the JAX package's ``_get_pblock_fn``).

    ``packed`` (B, 26) float64 holds the block's images (columns as
    PACKED_COLUMNS says); ``tables`` comes from :func:`_device_hkl_tables`.
    Pass 1 screens every (image, hkl) pair of each hkl chunk in float32:
    the Ewald sign test on the cancellation-free q = 2 s0.r + |r|^2 (same
    sign as |s0 + r| - |s0|) at the image's start and end, accepting a sign
    flip or |q| <= 1e-3 at either end, then |r1|^2 within the resolution
    limit (widened by 1e-5), hkl != 000 and a live image.  The products are
    elementwise float32 multiplies and adds, never a matrix product, so
    TF32 cannot reach them (its ~1e-3 error would drop rays against the
    band; float32's is ~1e-6).  Each chunk's candidates, image-major, are
    compacted to ``chunk_cap``; the chunks merge in order into one
    ``cap``-sized set, and pass 2 (:func:`_rays_rowwise`, float64) decides
    them.

    Returns one (cap + 1, 8) float64 tensor: rows of [s1 (3), angle,
    image in block, hkl index, entering, valid], then [the wide candidates
    summed over chunks, the most in one chunk, 0 ...] (both at least their
    survivors' counts, so a retry on them is conservative)."""
    h32, h_nonzero, h64 = tables
    n_chunks, _, ch = h32.shape
    b = packed.shape[0]
    a1b = packed[:, 0:9].reshape(b, 3, 3)
    a2b = packed[:, 9:18].reshape(b, 3, 3)
    s01b, s02b = packed[:, 18:21], packed[:, 21:24]
    phib, liveb = packed[:, 24], packed[:, 25] > 0.5
    # both ends of every image as one (2B, ...) batch
    a32 = torch.cat([a1b, a2b]).float()
    two_s0 = 2.0 * torch.cat([s01b, s02b]).float()
    band = float(np.float32(1e-3))
    res_lim = float(np.float32(1.0 / (dmin * dmin) * (1.0 + 1e-5)))

    c_img, c_hkl, c_valid, c_cnt = [], [], [], []
    for c in range(n_chunks):
        hc = h32[c]  # (3, ch)
        r = a32[:, :, 0, None] * hc[0] + a32[:, :, 1, None] * hc[1] + a32[:, :, 2, None] * hc[2]
        q = (r * (two_s0[:, :, None] + r)).sum(1)  # (2B, ch)
        q1, q2 = q[:b], q[b:]
        flip = (q1 >= 0.0) != (q2 >= 0.0)
        near = (q1.abs() <= band) | (q2.abs() <= band)
        res = (r[:b] * r[:b]).sum(1) <= res_lim
        okf = ((flip | near) & res & h_nonzero[c] & liveb[:, None]).reshape(-1)
        idx, cvalid = _compact_i32(okf, chunk_cap)
        idx = idx.clamp_max(okf.shape[0] - 1)
        c_img.append(idx // ch)  # image within the block
        c_hkl.append(idx % ch + c * ch)  # hkl index in the grid
        c_valid.append(cvalid)
        c_cnt.append(okf.sum(dtype=torch.int32))

    # merge the chunks' candidates, in chunk order, into one cap-sized set
    vflat = torch.cat(c_valid)
    sel, valid = _compact_i32(vflat, cap)
    sel = sel.clamp_max(vflat.shape[0] - 1)
    img_i = torch.cat(c_img)[sel].long()
    hkl_i = torch.cat(c_hkl)[sel].long()

    ok2, s1, ang, ent = _rays_rowwise(h64[hkl_i], a1b[img_i], a2b[img_i], s01b[img_i],
                                      s02b[img_i], dmin, phib[img_i], d_osc)
    meta = torch.stack([img_i.double(), hkl_i.double(), ent.double(), (valid & ok2).double()], 1)
    rows = torch.cat([s1, ang[:, None], meta], 1)
    cnt = torch.stack(c_cnt)
    counts = torch.stack([cnt.sum(), cnt.max()]).double()
    return torch.cat([rows, torch.nn.functional.pad(counts, (0, 6))[None]])


_hkl_dev_cache: dict = {}


def _device_hkl_tables(hkl_pad: np.ndarray, n_chunks: int, ch: int, device: torch.device):
    """The block's hkl tables on ``device``, cached by device and content
    (the grid is the same across calls for one experiment): the float32
    pass-1 chunks (n_chunks, 3, ch), their hkl != 000 mask (n_chunks, ch)
    and the float64 grid (n_chunks * ch, 3) for pass 2."""
    import hashlib

    device = torch.device(device)
    key = (str(device), n_chunks, ch, hashlib.md5(hkl_pad.tobytes()).hexdigest())
    if key not in _hkl_dev_cache:
        if len(_hkl_dev_cache) > 4:  # a few grids at most live at once
            _hkl_dev_cache.clear()
        chunks = np.ascontiguousarray(hkl_pad.reshape(n_chunks, ch, 3).transpose(0, 2, 1))
        _hkl_dev_cache[key] = (
            torch.from_numpy(chunks.astype(np.float32)).to(device),
            torch.from_numpy((chunks != 0).any(axis=1)).to(device),
            torch.from_numpy(hkl_pad.astype(np.float64)).to(device),
        )
    return _hkl_dev_cache[key]


def _hkl_tables(hkl: np.ndarray, hkl_chunk: int, device: torch.device):
    """(tables, ch): the grid zero-padded to whole chunks of
    ``ch = min(hkl_chunk, len(hkl))`` rows, as :func:`_device_hkl_tables`."""
    n_hkl = len(hkl)
    ch = min(hkl_chunk, n_hkl)
    n_chunks = (n_hkl + ch - 1) // ch
    hkl_pad = np.zeros((n_chunks * ch, 3), hkl.dtype)
    hkl_pad[:n_hkl] = hkl
    return _device_hkl_tables(hkl_pad, n_chunks, ch, device), ch


def _packed_states(experiment, sv, n_images: int, osc0: float, d_osc: float, img_block: int):
    """(packed (n_pad, 26) float64, img_block): every image's states in
    PACKED_COLUMNS order, padded to whole blocks of
    ``min(img_block, n_images)`` images with identity matrices, the static
    beam and live = 0."""
    img_block = max(1, min(img_block, n_images))
    n_pad = -(-n_images // img_block) * img_block
    packed = np.zeros((n_pad, PACKED_COLUMNS))
    packed[:, 0:9] = packed[:, 9:18] = np.eye(3).ravel()
    packed[:, 18:21] = packed[:, 21:24] = experiment.beam.s0
    a1, a2, s01, s02, phis = _image_states(experiment, sv, n_images, osc0, d_osc)
    packed[:n_images] = np.concatenate(
        [a1.reshape(-1, 9), a2.reshape(-1, 9), s01, s02, phis[:, None], np.ones((n_images, 1))],
        axis=1,
    )
    return packed, img_block


def _predict_rotation_device(
    experiment,
    sv: ScanVaryingData,
    hkl: np.ndarray,
    dmin: float,
    d_osc: float,
    osc0: float,
    z0: int,
    n_images: int,
    img_block: int = 32,
    # wide candidates an image: thaumatin-scale counts are ~145 an image,
    # and an overflow re-runs the block at a doubled capacity
    cap_per_image: int = 256,
    hkl_chunk: int = 1 << 17,
    *,
    device: torch.device | None = None,
) -> PredictedReflections:
    """The blocked two-pass search (the JAX package's
    ``_predict_rotation_device``): :func:`_prediction_block` for every
    ``img_block`` images, one upload of the block's packed states and one
    download of its packed result.  Where the wide candidates overflowed
    the block's capacity (``img_block * cap_per_image``) or a chunk's
    (:func:`_default_chunk_cap`), the capacity that overflowed grows and
    the block runs again.  The on-panel test (in mm) and the frame numbers
    run on the host."""
    if device is None:
        from ..utils.torchinit import select_device

        device = select_device()
    panel = experiment.panel
    packed_all, img_block = _packed_states(experiment, sv, n_images, osc0, d_osc, img_block)
    tables, _ = _hkl_tables(hkl, hkl_chunk, device)
    cap = img_block * cap_per_image
    chunk_cap = _default_chunk_cap(cap)

    def run_block(packed_dev):
        out = _prediction_block(packed_dev, tables, cap, chunk_cap, dmin, d_osc).cpu().numpy()
        return out[:-1], out[-1, :2]

    w, hh = panel.image_size
    # on-panel bounds in mm, matching dx2 Panel::get_ray_intersection's
    # optional (reference: predict.cc:106 drops only rays with no mm
    # intersection)
    wmm = w * panel.pixel_size[0]
    hmm = hh * panel.pixel_size[1]
    out_hkl, out_s1, out_px, out_mm, out_panel, out_entering = ([], [], [], [], [], [])
    for b0 in range(0, len(packed_all), img_block):
        packed_dev = torch.from_numpy(packed_all[b0 : b0 + img_block]).to(device)
        rows, counts = run_block(packed_dev)
        while _overflowed(counts, cap, chunk_cap):  # later blocks keep the grown capacities
            cap, chunk_cap = _grown(counts, cap, chunk_cap)
            rows, counts = run_block(packed_dev)
        rows = rows[rows[:, 7] > 0]
        if not len(rows):
            continue
        s1c, angc = rows[:, :3], rows[:, 3]
        img_i, hkl_i = rows[:, 4].astype(np.int64), rows[:, 5].astype(np.int64)
        xmm, ymm = panel.get_ray_intersection(s1c)
        x_px, y_px = panel.mm_to_px(xmm, ymm)
        on_panel = (xmm >= 0) & (xmm < wmm) & (ymm >= 0) & (ymm < hmm)
        if not on_panel.any():
            continue
        sel = np.nonzero(on_panel)[0]
        frame = z0 + (angc[sel] - osc0) / d_osc
        out_hkl.append(hkl[hkl_i[sel]])
        out_s1.append(s1c[sel])
        out_px.append(np.stack([x_px[sel], y_px[sel], frame], axis=1))
        out_mm.append(np.stack([xmm[sel], ymm[sel], np.deg2rad(angc[sel])], axis=1))
        out_panel.append((b0 + img_i[sel]) * 0)  # single panel
        out_entering.append(rows[sel, 6] > 0)

    if not out_hkl:
        return _no_reflections()
    hkl_all = np.concatenate(out_hkl)
    return PredictedReflections(
        hkl=hkl_all.astype(np.int64),
        s1=np.concatenate(out_s1),
        xyzcal_px=np.concatenate(out_px),
        xyzcal_mm=np.concatenate(out_mm),
        panel=np.concatenate(out_panel).astype(np.uint64),
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
