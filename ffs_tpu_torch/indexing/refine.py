"""Candidate refinement: 18-parameter Levenberg-Marquardt on (x, y, phi).

Counterpart of :mod:`ffs_tpu.indexing.refine` (reference: the Eigen LM
refinement over beam (mu1, mu2, nu), orientation (phi1..3 mrad), cell (6
metrical parameters x 1e5) and detector (dist, shift1, shift2, tau1..3 mrad)
parameterisations, baseline/refiner/*.cc, baseline/indexer/
refine_candidate.cc:56-96, target.cc:107-152).  The residual and the
parameterisations are float64 PyTorch; the Jacobian comes from
``torch.func.jacfwd`` through the vectorised scan-static predictor (the
copied :func:`.predict.predict_scan_static`, driven through :data:`TORCH_XP`)
and feeds the copied MINPACK-semantics :func:`.lm.lmder`.

Placement: refinement runs on the CPU in float64, as the reference runs it
(Eigen on the host) and as the JAX package pins it.  It is a few hundred
residuals and 18 parameters a candidate, far below what a device launch
pays for, and it needs float64 3x3 inverses.  This is the reference's
placement, not a fallback: nothing here selects or falls back from a GPU.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from ..models.crystal import Crystal
from .lm import lmder
from .predict import predict_scan_static

_F64 = torch.float64
_CPU = torch.device("cpu")
# Forward-mode AD levels are process-global in PyTorch, not per thread: two
# jacfwd calls from the indexer's scoring threads would tear down each
# other's level.  Jacobians are taken one at a time; everything else a
# candidate does still runs in parallel.
_JACFWD_LOCK = threading.Lock()


def _t(x) -> torch.Tensor:
    """A float64 CPU tensor of ``x`` (tensors pass through)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=_F64, device=_CPU)


def _asarray(x, dtype=None):
    if isinstance(dtype, torch.dtype):
        pass
    elif dtype is not None:
        dtype = torch.from_numpy(np.zeros(0, dtype=dtype)).dtype
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=_CPU)


def _maximum(a, b):
    return torch.clamp_min(a, b) if not isinstance(b, torch.Tensor) else torch.maximum(a, b)


# The array namespace :func:`predict_scan_static` takes as ``xp``: the
# NumPy names it calls, mapped onto PyTorch (cross over the last axis,
# floor-mod as ``remainder``, ``axis`` keywords as ``dim``).
TORCH_XP = SimpleNamespace(
    asarray=_asarray,
    linalg=SimpleNamespace(inv=torch.linalg.inv, norm=torch.linalg.norm),
    cross=lambda a, b: torch.linalg.cross(a, b, dim=-1),
    sum=lambda x, axis=None: torch.sum(x, dim=axis),
    where=torch.where,
    sqrt=torch.sqrt,
    maximum=_maximum,
    cos=torch.cos,
    sin=torch.sin,
    abs=torch.abs,
    floor=torch.floor,
    arctan2=torch.atan2,
    mod=torch.remainder,
    broadcast_to=torch.broadcast_to,
    stack=lambda xs, axis=0: torch.stack(xs, dim=axis),
)


def _axis_angle_rot(axis, angle):
    """Rotation matrix about unit axis (built with torch.stack so that
    forward-mode autodiff sees every entry)."""
    c = torch.cos(angle)
    s = torch.sin(angle)
    x, y, z = axis[0], axis[1], axis[2]
    zero = torch.zeros_like(x)
    K = torch.stack(
        [torch.stack([zero, -z, y]), torch.stack([z, zero, -x]), torch.stack([-y, x, zero])]
    )
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return c * eye + s * K + (1 - c) * torch.outer(axis, axis)


def compose_beam(params, istate_s0_dir, dir1, dir2):
    """s0 from (mu1, mu2 [mrad], nu=|s0|) (beam_parameterisation.cc:43-66)."""
    mu1, mu2, nu = params[0], params[1], params[2]
    R = _axis_angle_rot(_t(dir2), mu2 / 1000.0) @ _axis_angle_rot(_t(dir1), mu1 / 1000.0)
    d = R @ _t(istate_s0_dir)
    return nu * d / torch.linalg.norm(d)


def compose_orientation(params, u0):
    """U from three axial rotations (mrad) about x, y, z
    (orientation_parameterisation.cc)."""
    p1, p2, p3 = params[0], params[1], params[2]
    ex, ey, ez = torch.eye(3, dtype=_F64, device=params.device)
    R1 = _axis_angle_rot(ex, p1 / 1000.0)
    R2 = _axis_angle_rot(ey, p2 / 1000.0)
    R3 = _axis_angle_rot(ez, p3 / 1000.0)
    return R3 @ R2 @ R1 @ _t(u0)


def b_matrix_from_metric(g6):
    """DIALS-convention B from the 6 reciprocal metric elements
    (g11, g22, g33, g12, g13, g23) — the P1 metrical-matrix
    parameterisation (cell_parameterisation.cc via rstbx
    SymmetrizeReduceEnlarge).

    Follows the reference's ``BG::back`` path exactly (reference:
    baseline/refiner/cell_parameterisation.cc:64-74): reciprocal metric ->
    direct cell -> B = inv(orth)^T with the standard PDB orthogonalisation
    (lower-triangular B, same frame as models.crystal.Crystal.b_matrix).
    """
    g11, g22, g33, g12, g13, g23 = (g6[i] for i in range(6))
    a_s = torch.sqrt(g11)
    b_s = torch.sqrt(g22)
    c_s = torch.sqrt(g33)
    cga_s = g12 / (a_s * b_s)  # cos gamma*
    cbe_s = g13 / (a_s * c_s)  # cos beta*
    cal_s = g23 / (b_s * c_s)  # cos alpha*
    sga_s = torch.sqrt(torch.clamp_min(1 - cga_s**2, 1e-12))
    sbe_s = torch.sqrt(torch.clamp_min(1 - cbe_s**2, 1e-12))
    sal_s = torch.sqrt(torch.clamp_min(1 - cal_s**2, 1e-12))
    vs = (
        a_s
        * b_s
        * c_s
        * torch.sqrt(
            torch.clamp_min(
                1 - cal_s**2 - cbe_s**2 - cga_s**2 + 2 * cal_s * cbe_s * cga_s,
                1e-16,
            )
        )
    )
    # direct cell from the reciprocal one
    a = b_s * c_s * sal_s / vs
    b = a_s * c_s * sbe_s / vs
    c = a_s * b_s * sga_s / vs
    ca = (cbe_s * cga_s - cal_s) / (sbe_s * sga_s)
    cb = (cal_s * cga_s - cbe_s) / (sal_s * sga_s)
    cg = (cal_s * cbe_s - cga_s) / (sal_s * sbe_s)
    sg = torch.sqrt(torch.clamp_min(1 - cg**2, 1e-12))
    w = torch.sqrt(torch.clamp_min(1 - ca**2 - cb**2 - cg**2 + 2 * ca * cb * cg, 1e-16))
    zero = torch.zeros_like(a)
    orth = torch.stack(
        [
            torch.stack([a, b * cg, c * cb]),
            torch.stack([zero, b * sg, c * (ca - cb * cg) / sg]),
            torch.stack([zero, zero, c * w / sg]),
        ]
    )
    return torch.linalg.inv(orth).mT


def metric_from_b(b_matrix) -> np.ndarray:
    """Inverse of b_matrix_from_metric: the 6 reciprocal metric elements."""
    g = np.asarray(b_matrix).T @ np.asarray(b_matrix)
    return np.array([g[0, 0], g[1, 1], g[2, 2], g[0, 1], g[0, 2], g[1, 2]])


def compose_detector(params, init):
    """Panel (fast, slow, origin) from (dist, shift1, shift2, tau1..3 [mrad])
    (detector_parameterisation.cc compose)."""
    dist, sh1, sh2, t1, t2, t3 = (params[i] for i in range(6))
    d1, d2, dn, offset = (_t(v) for v in init)
    T1 = _axis_angle_rot(dn, t1 / 1000.0)
    T2 = _axis_angle_rot(d1, t2 / 1000.0)
    T3 = _axis_angle_rot(d2, t3 / 1000.0)
    T32 = T3 @ T2
    T321 = T32 @ T1
    P0 = dist * dn
    dsv = P0 + sh1 * d1 + sh2 * d2
    dorg = T321 @ dsv - T32 @ P0 + P0
    new_d1 = T321 @ d1
    new_d1 = new_d1 / torch.linalg.norm(new_d1)
    new_d2 = T321 @ d2
    new_d2 = new_d2 / torch.linalg.norm(new_d2)
    origin = dorg + offset[0] * new_d1 + offset[1] * new_d2
    return new_d1, new_d2, origin


@dataclass
class RefineSetup:
    """Fixed quantities captured before refinement (host side)."""

    u0: np.ndarray
    g6_0: np.ndarray
    s0_dir: np.ndarray
    s0_norm: float
    beam_dir1: np.ndarray
    beam_dir2: np.ndarray
    det_init: tuple  # (d1, d2, dn, offset)
    fixed_rotation: np.ndarray
    setting_rotation: np.ndarray
    rotation_axis: np.ndarray


def make_setup(crystal: Crystal, beam, panel, gonio) -> RefineSetup:
    s0 = beam.s0
    spindle = gonio.rotation_axis
    dir2 = np.cross(s0, spindle)
    dir2 /= np.linalg.norm(dir2)
    dir1 = np.cross(dir2, s0)
    dir1 /= np.linalg.norm(dir1)

    d1 = panel.fast_axis / np.linalg.norm(panel.fast_axis)
    d2 = panel.slow_axis / np.linalg.norm(panel.slow_axis)
    dn = np.cross(d1, d2)
    dn /= np.linalg.norm(dn)
    # DIALS parameterises about the panel CENTRE: the frame origin dorg is
    # the centre, the panel origin sits at a fixed in-plane offset of
    # (-width/2, -height/2) mm from it, and tau rotations pivot there
    # (reference: detector_parameterisation.cc:167-180)
    origin = panel.origin
    offset = np.array(
        [
            -0.5 * panel.image_size[0] * panel.pixel_size[0],
            -0.5 * panel.image_size[1] * panel.pixel_size[1],
        ]
    )
    dorg = origin - offset[0] * d1 - offset[1] * d2
    dist = origin @ dn  # directed distance (offsets are in-plane)
    shift = dorg - dist * dn
    sh1 = shift @ d1
    sh2 = shift @ d2
    return RefineSetup(
        u0=crystal.u_matrix,
        g6_0=metric_from_b(crystal.b_matrix),
        s0_dir=s0 / np.linalg.norm(s0),
        s0_norm=float(np.linalg.norm(s0)),
        beam_dir1=dir1,
        beam_dir2=dir2,
        det_init=(d1, d2, dn, offset, dist, sh1, sh2),
        fixed_rotation=gonio.fixed_rotation,
        setting_rotation=gonio.setting_rotation,
        rotation_axis=gonio.rotation_axis,
    )


def _residual_fn(setup: RefineSetup, hkl, entering, xyzobs_mm):
    """x (18,) float64 tensor -> residuals [dx..., dy..., dphi...] (3N,)."""
    d1_0, d2_0, dn_0, offset, dist0, sh1_0, sh2_0 = setup.det_init
    u0 = _t(setup.u0)
    fixed = _t(setup.fixed_rotation)
    setting = _t(setup.setting_rotation)
    axis = _t(setup.rotation_axis)
    hkl_t = _t(np.asarray(hkl, dtype=np.float64))
    entering_t = torch.as_tensor(np.asarray(entering, dtype=bool))
    obs = _t(xyzobs_mm)
    s0_dir, bd1, bd2 = _t(setup.s0_dir), _t(setup.beam_dir1), _t(setup.beam_dir2)
    det0 = (_t(d1_0), _t(d2_0), _t(dn_0), _t(offset))

    def residuals(x):
        s0 = compose_beam(x[0:3], s0_dir, bd1, bd2)
        u = compose_orientation(x[3:6], u0)
        b = b_matrix_from_metric(x[6:12] / 1e5)
        ub = u @ b
        fast, slow, origin = compose_detector(x[12:18], det0)
        d_matrix = torch.stack([fast, slow, origin], dim=1)
        pred = predict_scan_static(
            hkl_t,
            entering_t,
            obs[:, 2],
            s0=s0,
            fixed_rotation=fixed,
            setting_rotation=setting,
            rotation_axis=axis,
            ub=ub,
            d_matrix=d_matrix,
            xp=TORCH_XP,
        )
        diff = torch.where(pred["valid"][:, None], pred["xyzcal_mm"] - obs, 0.0)
        return diff.mT.reshape(-1)  # [dx..., dy..., dphi...]

    return residuals


def refine_candidate(
    crystal: Crystal,
    beam,
    panel,
    gonio,
    hkl: np.ndarray,
    entering: np.ndarray,
    xyzobs_mm: np.ndarray,
    maxfev: int = 10,
    ftol: float = 1e-6,
    xtol: float = 1e-6,
    fix_in_spindle_plane: bool = True,
    fix_wavelength: bool = True,
):
    """LM refinement; returns (crystal', s0', d_matrix', rmsds (3,)).

    Parameter layout matches refine_candidate.cc:62-96; the optimizer is
    the MINPACK-semantics trust-region LM (indexing/lm.py), with the
    reference's own settings ftol=xtol=1e-6 and a maxfev=10
    function-evaluation budget (refine_candidate.cc:78-86).

    The beam's in-spindle-plane rotation (mu1) and wavelength (nu) are
    frozen by default, as the reference defaults them
    (beam_parameterisation.cc:37-39; gradients_calculator.cc:99-112): a
    free |s0| is exactly degenerate with the reciprocal-cell scale.

    Runs on the CPU in float64 (see the module docstring).
    """
    setup = make_setup(crystal, beam, panel, gonio)
    d1_0, d2_0, dn_0, offset, dist0, sh1_0, sh2_0 = setup.det_init
    x0 = np.zeros(18)
    x0[2] = setup.s0_norm
    x0[6:12] = 1e5 * setup.g6_0
    x0[12:15] = [dist0, sh1_0, sh2_0]

    fn = _residual_fn(setup, hkl, entering, xyzobs_mm)
    free = np.ones(18, dtype=bool)
    if fix_in_spindle_plane:
        free[0] = False
    if fix_wavelength:
        free[2] = False
    x0_t = _t(x0)
    free_t = torch.as_tensor(free)

    def fn_masked(x):
        # frozen parameters: residuals are independent of them, so their
        # Jacobian columns are exactly zero (= the reference's masking)
        return fn(torch.where(free_t, x, x0_t))

    jacfwd = torch.func.jacfwd(fn_masked)

    def jac(v):
        with _JACFWD_LOCK:
            return jacfwd(_t(v)).numpy()

    with torch.no_grad():
        res = lmder(
            lambda v: fn_masked(_t(v)).numpy(),
            jac,
            x0,
            ftol=ftol,
            xtol=xtol,
            maxfev=maxfev,
        )
        # zero-column directions never move (min-norm lmpar steps), but pin
        # the frozen slots to the initial state explicitly regardless
        x, r = np.where(free, res.x, x0), res.fvec
        n = len(hkl)
        rr = np.asarray(r).reshape(3, n)
        rmsds = np.sqrt((rr**2).mean(axis=1))

        xt = _t(x)
        s0 = compose_beam(
            xt[0:3], _t(setup.s0_dir), _t(setup.beam_dir1), _t(setup.beam_dir2)
        ).numpy()
        u = compose_orientation(xt[3:6], _t(setup.u0)).numpy()
        b = b_matrix_from_metric(xt[6:12] / 1e5).numpy()
        fast, slow, origin = (
            v.numpy() for v in compose_detector(xt[12:18], (d1_0, d2_0, dn_0, offset))
        )
    a_matrix = u @ b
    return Crystal.from_a_matrix(a_matrix), s0, (fast, slow, origin), rmsds
