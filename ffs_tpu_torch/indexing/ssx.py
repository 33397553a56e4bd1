"""Serial-crystallography (stills) indexing with a known unit cell.

Counterpart of :mod:`ffs_tpu.indexing.ssx` (the replacement for the
external PSI ffbidx CUDA indexer the reference wraps, reference:
src/ffs/ssx_index.py:40-159, plus a port of the reference's own
``ffs.index.index_from_ssx_cells`` candidate selection, prediction and rmsd
logic, baseline/indexer/index_module.cpp:49-201).

The vector search: for each known cell-vector length, score every direction
on a Fibonacci half-sphere by the lattice fitness

    score(v) = sum_spots cos(2 pi rlp . v)

one (spots x directions) float32 matrix product plus an elementwise cos and
a weighted sum, on the indexer's device (:func:`ssx_scores`,
:func:`ssx_topk`).  The top-scoring directions are picked for diversity on
the host, gradient-refined on the device (:func:`ssx_refine`) and
assembled into candidate cells consistent with the target cell's angles.

A device failure raises: nothing here catches it and carries on.  The
float64 NumPy search runs only when the caller asks for it with
``use_device=False``; it is the plain reference the device search is held
to.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.crystal import Crystal
from ..prediction.stills import predict_stills
from ..utils import torchinit
from .assign import assign_indices_global


def fibonacci_half_sphere(n: int) -> np.ndarray:
    """n approximately uniform directions with z >= 0."""
    i = np.arange(n, dtype=np.float64)
    golden = (1 + np.sqrt(5)) / 2
    z = i / n  # upper half only
    r = np.sqrt(1 - z * z)
    theta = 2 * np.pi * i / golden
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=1)


_REFINE_STEPS = 40
_TOPK = 512  # score-ordered direction candidates handed to the greedy pick
_CHUNK = 2048  # directions a step of the score: the (B, S, C) projection
_TWO_PI = np.float32(2 * np.pi)
_dirs_cache: dict = {}


def device_dirs(n: int, device: torch.device) -> torch.Tensor:
    """Device-resident float32 half-sphere, cached per (n, device) (the
    (32768, 3) table is uploaded once, not per image)."""
    key = (n, torch.device(device))
    if key not in _dirs_cache:
        if len(_dirs_cache) > 4:  # bounded: long-lived services vary n
            _dirs_cache.clear()
        table = fibonacci_half_sphere(n).astype(np.float32)
        _dirs_cache[key] = torch.from_numpy(table).to(device)
    return _dirs_cache[key]


def ssx_scores(rlp: torch.Tensor, w: torch.Tensor, lengths: torch.Tensor,
               dirs: torch.Tensor, chunk: int = _CHUNK) -> torch.Tensor:
    """score[b, l, d] = sum_s w[b, s] * cos(2 pi * len_l * (rlp_bs . dir_d)),
    float32, (B, 3, D).

    The (B, S, C) projection of a chunk of C directions is computed once
    and shared by the three lengths (v = l*d, so rlp.v = l*(rlp.d)); the
    cos and the weighted sum run per length, so the (B, S, D) projection is
    never whole (at D = 32768 it would be ~1 GB for a 16-image batch).
    Float32 with TF32 off (``torchinit.setup``): TF32's 10-bit mantissa
    would turn into a phase error of cos(2 pi len proj) that grows with
    the cell axis, as bf16 passes did on the TPU.
    """
    D = dirs.shape[0]
    scale = _TWO_PI * lengths.to(torch.float32)  # (3,)
    out = torch.empty((rlp.shape[0], 3, D), dtype=torch.float32, device=rlp.device)
    wcol = w.to(torch.float32)[:, None, :]  # (B, 1, S)
    for lo in range(0, D, chunk):
        dd = dirs[lo : lo + chunk]
        proj = torch.matmul(rlp, dd.T)  # (B, S, C)
        for li in range(3):
            out[:, li, lo : lo + dd.shape[0]] = torch.bmm(wcol, torch.cos(scale[li] * proj))[:, 0]
    return out


def ssx_topk(rlp: torch.Tensor, w: torch.Tensor, lengths: torch.Tensor,
             dirs: torch.Tensor, k: int = _TOPK) -> torch.Tensor:
    """The k best direction indices per (image, length), best first:
    int64 (B, 3, k)."""
    scores = ssx_scores(rlp, w, lengths, dirs)
    B, _, D = scores.shape
    _, idx = torch.topk(scores.reshape(B * 3, D), k, dim=1, largest=True, sorted=True)
    return idx.reshape(B, 3, k)


def ssx_refine(rlp: torch.Tensor, w: torch.Tensor, n_real: torch.Tensor,
               v0: torch.Tensor, steps: int = _REFINE_STEPS) -> torch.Tensor:
    """Gradient-ascent refinement of the picked candidate vectors, all
    images, lengths and picks at once: v0 (B, 3, P, 3) float32.  Zero-padded
    pick slots have zero gradient and stay zero."""
    h = (_TWO_PI * _TWO_PI) * torch.clamp_min(n_real.to(torch.float32), 1.0)  # (B,)
    h = h[:, None, None, None]
    wv = w.to(torch.float32)[:, :, None, None]
    v = v0
    for _ in range(steps):
        proj = torch.einsum("bsk,bljk->bslj", rlp, v)
        sinp = torch.sin(_TWO_PI * proj) * wv
        g = -_TWO_PI * torch.einsum("bslj,bsk->bljk", sinp, rlp)
        v = v + g / h
    return v


def _pad_rlp_batch(rlps: list[np.ndarray]):
    """(B, S, 3) f32 + (B, S) weights, S bucketed to a multiple of 128 (the
    JAX package's compile buckets; kept so both see the same shapes)."""
    S = max(128, -(-max(len(r) for r in rlps) // 128) * 128)
    B = len(rlps)
    out = np.zeros((B, S, 3), dtype=np.float32)
    w = np.zeros((B, S), dtype=np.float32)
    for i, r in enumerate(rlps):
        out[i, : len(r)] = r
        w[i, : len(r)] = 1.0
    return out, w, np.array([len(r) for r in rlps], dtype=np.float32)


def _greedy_diverse_pick(dirs: np.ndarray, order: np.ndarray, max_pick: int):
    """Score-order greedy pick with the 0.95-|cos| diversity exclusion,
    vectorised: each accepted direction excludes its near-(anti)parallel
    cone from the remaining candidates in one masked dot product."""
    sel: list[int] = []
    excluded = np.zeros(len(order), dtype=bool)
    cand = dirs[order]  # (K, 3) unit
    for j in range(len(order)):
        if excluded[j]:
            continue
        sel.append(int(order[j]))
        if len(sel) >= max_pick:
            break
        excluded |= np.abs(cand @ cand[j]) > 0.95
    return sel


def _assemble_cells(
    cand: list[np.ndarray],
    cell,
    angle_tolerance: float,
    max_output_cells: int,
) -> list[np.ndarray]:
    """Angle-consistent candidate cell assembly, vectorised.

    Enumerates (va, vb, vc, +-vc) in the same lexicographic order as the
    reference's nested search (index_module.cpp:49-201 analogue): all
    pairwise angles are precomputed as matrices, the 4-D pass mask is
    built with numpy, and np.argwhere's C-order yields exactly the
    nested-loop emission order, truncated at max_output_cells.
    """
    a, b, c, alpha, beta, gamma = cell
    A, Bv, Cv = (np.asarray(v, dtype=np.float64) for v in cand)
    if not (len(A) and len(Bv) and len(Cv)):
        return []

    def units(m):
        return m / np.linalg.norm(m, axis=1, keepdims=True)

    ua, ub, uc = units(A), units(Bv), units(Cv)

    def ang(u, v):  # (n, 3) x (m, 3) -> degrees (n, m)
        return np.degrees(np.arccos(np.clip(u @ v.T, -1.0, 1.0)))

    ang_ab = ang(ua, ub)  # gamma candidates
    ang_ac = ang(ua, uc)  # beta
    ang_bc = ang(ub, uc)  # alpha

    g_ok = np.abs(ang_ab - gamma) <= angle_tolerance
    g_ok_flip = np.abs(180.0 - ang_ab - gamma) <= angle_tolerance
    pair_ab = g_ok | g_ok_flip
    b_flip = ~g_ok & g_ok_flip  # vb_s = -vb exactly when only the flip passes

    # beta test on (va, s*vc): s=+ uses ang_ac, s=- its supplement
    beta_ok = np.stack(
        [
            np.abs(ang_ac - beta) <= angle_tolerance,
            np.abs(180.0 - ang_ac - beta) <= angle_tolerance,
        ],
        axis=-1,
    )  # (na, nc, 2)
    # alpha test on (vb_s, s*vc): supplement iff exactly one of (b_flip, s-) flips
    alpha_pass = np.abs(ang_bc - alpha) <= angle_tolerance  # (nb, nc)
    alpha_supp = np.abs(180.0 - ang_bc - alpha) <= angle_tolerance
    # cond[a, b, c, s]
    alpha_ok = np.empty((len(A), len(Bv), len(Cv), 2), dtype=bool)
    alpha_ok[:, :, :, 0] = np.where(
        b_flip[:, :, None], alpha_supp[None], alpha_pass[None]
    )
    alpha_ok[:, :, :, 1] = np.where(
        b_flip[:, :, None], alpha_pass[None], alpha_supp[None]
    )
    cond = (
        pair_ab[:, :, None, None]
        & beta_ok[:, None, :, :]
        & alpha_ok
    )
    hits = np.argwhere(cond)[:max_output_cells]

    cells: list[np.ndarray] = []
    for ia, ib, ic, s in hits:
        vb_s = -Bv[ib] if b_flip[ia, ib] else Bv[ib]
        vc_s = -Cv[ic] if s else Cv[ic]
        m = np.stack([A[ia], vb_s, vc_s])
        if np.linalg.det(m) < 0:
            # negating the WHOLE triple preserves every mutual angle and
            # flips handedness; negating one vector would turn the
            # just-checked alpha/beta into their supplements (and -vc is
            # enumerated by the loop anyway)
            m = -m
        cells.append(m)
    return cells


class _Clock:
    """Accumulates wall seconds per stage into a dict (a no-op without one)."""

    def __init__(self, sink: dict | None):
        self.sink = sink
        self.t = time.perf_counter()

    def lap(self, stage: str) -> None:
        if self.sink is None:
            return
        now = time.perf_counter()
        self.sink[stage] = self.sink.get(stage, 0.0) + now - self.t
        self.t = now


def _host_topk(rlps, lengths, dirs_np) -> np.ndarray:
    """The float64 NumPy score and top-k (the plain reference)."""
    topk_idx = np.empty((len(rlps), 3, _TOPK), dtype=np.int64)
    for i, r in enumerate(rlps):
        proj = np.asarray(r, dtype=np.float64) @ dirs_np.T  # (n, D)
        for li in range(3):
            s = np.cos(2 * np.pi * float(lengths[li]) * proj).sum(axis=0)
            part = np.argpartition(s, -_TOPK)[-_TOPK:]
            topk_idx[i, li] = part[np.argsort(s[part])[::-1]]
    return topk_idx


def _host_refine(rlps, v0) -> np.ndarray:
    """The float64 NumPy refinement (the plain reference)."""
    P = v0.shape[2]
    refined = v0.astype(np.float64).copy()
    for i, r in enumerate(rlps):
        r = np.asarray(r, dtype=np.float64)
        h = (2 * np.pi) ** 2 * max(len(r), 1)
        v = refined[i].reshape(-1, 3)
        for _ in range(_REFINE_STEPS):
            proj = v @ r.T  # (3P, n)
            v = v + (-2 * np.pi) * (np.sin(2 * np.pi * proj) @ r) / h
        refined[i] = v.reshape(3, P, 3)
    return refined


def find_candidate_cells_batch(
    rlps: list[np.ndarray],
    cell: tuple[float, float, float, float, float, float],
    *,
    num_halfsphere_points: int = 32768,
    num_candidate_vectors: int = 32,
    max_output_cells: int = 32,
    angle_tolerance: float = 3.0,
    length_tolerance: float = 0.05,
    use_device: bool = True,
    device: torch.device | None = None,
    timings: dict | None = None,
) -> list[list[np.ndarray]]:
    """Candidate cells for a batch of stills.

    With ``use_device`` (the default), two device steps on ``device``
    (default :func:`torchinit.select_device`): the score and top-k of every
    (direction, length) pair of every image (:func:`ssx_topk`), and, after
    the host's greedy diversity pick, the refinement of all picked vectors
    (:func:`ssx_refine`).  Either raises on failure.  ``use_device=False``
    runs the float64 NumPy search instead.  ``timings``, if given, gains
    the seconds of ``score``, ``pick``, ``refine`` and ``assemble`` (device
    work synchronised before each reading).
    """
    lengths = np.asarray(cell[:3], dtype=np.float32)
    dirs_np = fibonacci_half_sphere(num_halfsphere_points)
    clock = _Clock(timings)
    if use_device:
        dev = torchinit.select_device() if device is None else torch.device(device)
        torchinit.setup()
        rlp_pad, w, n_real = _pad_rlp_batch(rlps)
        rlp_t = torch.from_numpy(rlp_pad).to(dev)
        w_t = torch.from_numpy(w).to(dev)
        dirs = device_dirs(num_halfsphere_points, dev)
        topk_idx = ssx_topk(rlp_t, w_t, torch.from_numpy(lengths).to(dev), dirs).cpu().numpy()
    else:
        topk_idx = _host_topk(rlps, lengths, dirs_np)
    clock.lap("score")

    # host: greedy diversity pick per (image, length); equal lengths give
    # equal score tables, hence equal picks — no special casing needed
    P = num_candidate_vectors
    v0 = np.zeros((len(rlps), 3, P, 3), dtype=np.float32)
    n_picked = np.zeros((len(rlps), 3), dtype=int)
    for i in range(len(rlps)):
        for li in range(3):
            sel = _greedy_diverse_pick(dirs_np, topk_idx[i, li], P)
            n_picked[i, li] = len(sel)
            v0[i, li, : len(sel)] = dirs_np[sel] * float(lengths[li])
    clock.lap("pick")

    if use_device:
        refined = ssx_refine(
            rlp_t, w_t, torch.from_numpy(n_real).to(dev), torch.from_numpy(v0).to(dev)
        ).cpu().numpy()
    else:
        refined = _host_refine(rlps, v0)
    clock.lap("refine")

    out: list[list[np.ndarray]] = []
    for i in range(len(rlps)):
        cand: list[np.ndarray] = []
        for li in range(3):
            vs = refined[i, li, : n_picked[i, li]].astype(np.float64)
            norms = np.linalg.norm(vs, axis=1)
            length = float(lengths[li])
            off = np.abs(norms - length) / length > length_tolerance
            vs[off] = vs[off] / norms[off, None] * length
            cand.append(vs)
        out.append(
            _assemble_cells(cand, cell, angle_tolerance, max_output_cells)
        )
    clock.lap("assemble")
    return out


def find_candidate_cells(
    rlp: np.ndarray,
    cell: tuple[float, float, float, float, float, float],
    **kwargs,
) -> list[np.ndarray]:
    """Candidate real-space cells (each a (3, 3) row matrix [a; b; c])."""
    return find_candidate_cells_batch([np.asarray(rlp)], cell, **kwargs)[0]


@dataclass
class SSXIndexingResult:
    cell_parameters: list
    a_matrix: np.ndarray
    miller_indices: np.ndarray
    xyzobs_px: np.ndarray
    xyzcal_px: np.ndarray
    s1: np.ndarray
    delpsi: np.ndarray
    rmsds: list = field(default_factory=list)


def index_from_ssx_cells(
    cells: list[np.ndarray],
    rlp: np.ndarray,
    xyzobs_px: np.ndarray,
    s0: np.ndarray,
    panel,
) -> SSXIndexingResult | None:
    """Pick the max-indexed candidate cell, predict stills positions,
    filter >2 px outliers, compute rmsds
    (reference: index_module.cpp:49-201)."""
    if not cells:
        return None
    best = None
    for m in cells:
        crystal = Crystal(m[0], m[1], m[2])
        hkl, n_indexed = assign_indices_global(crystal.a_matrix, rlp, xyzobs_px)
        if best is None or n_indexed > best[1]:
            best = (crystal, n_indexed, hkl)
    crystal, n_indexed, hkl = best
    if n_indexed == 0:
        return None

    sel = ~(hkl == 0).all(axis=1)
    hkl_sel = hkl[sel]
    obs_sel = np.asarray(xyzobs_px)[sel]
    A = crystal.a_matrix  # == U @ B without the extra inversion round trip

    pred = predict_stills(hkl_sel, s0, A, panel)
    dx = obs_sel[:, 0] - pred["xyzcal_px"][:, 0]
    dy = obs_sel[:, 1] - pred["xyzcal_px"][:, 1]
    good = np.sqrt(dx * dx + dy * dy) < 2.0
    rmsds = []
    if good.any():
        rmsds = [
            float(np.sqrt(np.mean(dx[good] ** 2))),
            float(np.sqrt(np.mean(dy[good] ** 2))),
            float(np.sqrt(np.mean(pred["delpsi"][good] ** 2))),
        ]

    return SSXIndexingResult(
        cell_parameters=list(crystal.unit_cell),
        a_matrix=A,
        miller_indices=hkl_sel[good],
        xyzobs_px=obs_sel[good],
        xyzcal_px=pred["xyzcal_px"][good],
        s1=pred["s1"][good],
        delpsi=pred["delpsi"][good],
        rmsds=rmsds,
    )


class SSXIndexer:
    """Drop-in equivalent of the reference GPUIndexer
    (reference: ssx_index.py:40-159).

    ``device`` is where the search runs; by default
    :func:`torchinit.select_device` (the card, or the CPU when
    ``FFS_TORCH_DEVICE=cpu``).  ``use_device=False`` runs the float64 NumPy
    search instead and needs no device.
    """

    def __init__(self, min_spots: int = 10, use_device: bool = True,
                 device: torch.device | None = None):
        self.min_spots = min_spots
        self.use_device = use_device
        self.device = None
        if use_device:
            self.device = torchinit.select_device() if device is None else torch.device(device)
        self.panel = None
        self.cell = None  # (a, b, c, alpha, beta, gamma)
        self._wavelength = None
        self.s0 = None

    @property
    def wavelength(self):
        return self._wavelength

    @wavelength.setter
    def wavelength(self, wl):
        self._wavelength = wl
        self.s0 = np.array([0.0, 0.0, -1.0 / wl])

    def index(self, xyzobs_px: np.ndarray):
        """Returns (SSXIndexingResult | None, n_unindexed)."""
        return self.index_batch([xyzobs_px])[0]

    def index_batch(self, images: list[np.ndarray], timings: dict | None = None):
        """Index a batch of stills: the candidate-vector search for every
        image runs as one score + top-k and one refinement on the device.
        Returns a list of (SSXIndexingResult | None, n_unindexed), one per
        image.  ``timings``, if given, gains the seconds of ``rlp``,
        ``score``, ``pick``, ``refine``, ``assemble`` and ``assign`` (the
        assignment, the stills prediction and the rmsds)."""
        from .rlp import ssx_xyz_to_rlp

        clock = _Clock(timings)
        prep = [
            np.asarray(x, dtype=np.float64).reshape(-1, 3) for x in images
        ]
        rlps, idxs = [], []
        for i, xyz in enumerate(prep):
            if len(xyz) >= self.min_spots:
                rlps.append(ssx_xyz_to_rlp(xyz, self.panel, self.wavelength))
                idxs.append(i)
        out: list = [(None, len(x)) for x in prep]
        clock.lap("rlp")
        if not rlps:
            return out
        cells_per = find_candidate_cells_batch(
            rlps, self.cell, use_device=self.use_device, device=self.device,
            timings=timings,
        )
        clock.t = time.perf_counter()
        for cells, rlp, i in zip(cells_per, rlps, idxs):
            result = index_from_ssx_cells(
                cells, rlp, prep[i], self.s0, self.panel
            )
            if result is not None:
                out[i] = (result, len(prep[i]) - len(result.delpsi))
        clock.lap("assign")
        return out
