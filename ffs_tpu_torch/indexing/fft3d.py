"""3D FFT of reciprocal-lattice points for basis-vector discovery.

Counterpart of :mod:`ffs_tpu.indexing.fft3d` (reference: baseline/indexer/
fft3d.cc:37-182): rlps are binned onto an n^3 grid with B-factor weights
exp(-b_iso |v|^2 / 4), transformed c2c, and the squared real part returned.
Grid binning stays in NumPy (a sparse scatter of ~10^4 points); the
transform is ``torch.fft.fftn`` in complex128 on the device (cuFFT on a
GPU).  Complex64 would not do: a single-precision transform of a 256^3
grid carries ~1e-3 relative error, which flips grid points across the
flood-fill threshold against the reference's double pocketfft.  At n = 256
the complex128 grid takes 268 MB of device memory.

A device failure raises; NumPy's FFT runs only when the caller asks for it
with ``use_device=False``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import torchinit


def b_iso_from_d_min(d_min: float) -> float:
    """b_iso = -4 d_min^2 ln(0.05) (reference: baseline/indexer/indexer.cc:205)."""
    return -4.0 * d_min * d_min * np.log(0.05)


def map_centroids_to_grid(
    rlp: np.ndarray,
    d_min: float,
    b_iso: float = 0.0,
    n_points: int = 256,
) -> tuple[np.ndarray, np.ndarray]:
    """Bin rlps to the FFT grid (reference: fft3d.cc:37-91).

    Returns (grid real f64 (n, n, n) with index order [vx, vy, vz],
    used_in_indexing bool (N,)).
    """
    rlp = np.asarray(rlp, dtype=np.float64)
    rlgrid = 2.0 / (d_min * n_points)
    half = n_points // 2
    v_len = np.linalg.norm(rlp, axis=1)
    d_spacing = np.divide(1.0, v_len, out=np.full(len(rlp), np.inf), where=v_len > 0)
    sel = d_spacing >= d_min

    coords = np.round(rlp / rlgrid).astype(np.int64) + half
    in_grid = (coords >= 0).all(axis=1) & (coords < n_points).all(axis=1)
    sel &= in_grid

    weights = np.exp(-b_iso * v_len**2 / 4.0) if b_iso != 0 else np.ones(len(rlp))
    grid = np.zeros((n_points, n_points, n_points), dtype=np.float64)
    c = coords[sel]
    # last write wins in the reference's loop; identical here since the
    # value only depends on |v| ~ the same grid point
    grid[c[:, 0], c[:, 1], c[:, 2]] = weights[sel]
    return grid, sel


def fft_power(grid: torch.Tensor) -> torch.Tensor:
    """Re(FFT(grid))^2 of a real float64 grid, in complex128 on its device."""
    return torch.square(torch.fft.fftn(grid.to(torch.complex128)).real)


def fft3d(
    rlp: np.ndarray,
    d_min: float,
    b_iso: float = 0.0,
    n_points: int = 256,
    use_device: bool = True,
    device: torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Grid + FFT -> (Re(FFT)^2 grid (n,n,n), used_in_indexing).

    Grid index order matches the reference's flattened layout
    (index = vz + n*vy + n^2*vx, fft3d.cc:84-86): axis 0 = vx.  The
    transform runs on ``device`` (default :func:`torchinit.select_device`);
    ``use_device=False`` runs NumPy's instead.
    """
    grid, used = map_centroids_to_grid(rlp, d_min, b_iso, n_points)
    if not use_device:
        return np.square(np.real(np.fft.fftn(grid))), used
    dev = torchinit.select_device() if device is None else torch.device(device)
    out = fft_power(torch.from_numpy(grid).to(dev))
    return out.cpu().numpy(), used
