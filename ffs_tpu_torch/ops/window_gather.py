"""Shoebox window gathers: CUDA kernels and plain versions.

Counterparts of :func:`ffs_tpu.ops.window_gather.window_gather_planes` and
:func:`ffs_tpu.ops.window_gather.window_gather`, the integrator's gathers of
fixed-size windows at per-reflection offsets:

    window_gather_planes(img, y0, x0, bh=bh)[a, p, r, c] = img[p, y0[a]+r, x0[a]+c]
    window_gather(img, y0, x0, bh=bh)[a, r, c]           = img[y0[a]+r, x0[a]+c]

for r < bh and c < 128; callers slice the columns they need.  ``img`` is
int32 or float32 (the TPU contract's >= 32-bit inputs; the output keeps the
input's type) and ``y0``/``x0`` are host arrays.  The contract is checked on
the host before anything runs, and a breach raises: ``Wp % 128 == 0``,
``Wp >= 256``, ``bh % 8 == 0``, ``0 <= x0 < Wp - 128`` (the TPU kernel's
strict bound) and ``0 <= y0``, ``y0 + bh <= Hp``.

Each wrapper picks by the image tensor's device: a CPU tensor takes the
plain PyTorch version (one advanced-indexing expression), a CUDA tensor
launches the kernel in ``csrc/window_gather.cu`` or raises; there is no
fallback between the two.  ``.launches`` on each wrapper counts its kernel
launches.
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 128
DTYPES = (torch.int32, torch.float32)


def _check(img: torch.Tensor, y0, x0, bh: int, planes: bool):
    """Validate a gather's arguments against the contract; returns the host
    offsets as int64 arrays."""
    if img.dtype not in DTYPES:
        raise TypeError(f"window gathers take int32 or float32 images, got {img.dtype}")
    if img.dim() != (3 if planes else 2):
        want = "(P, Hp, Wp)" if planes else "(Hp, Wp)"
        raise ValueError(f"image must be {want}, got {tuple(img.shape)}")
    hp, wp = img.shape[-2:]
    if wp % LANES or wp < 2 * LANES:
        raise ValueError(f"image width {wp} must be a multiple of 128 and >= 256; pad the image")
    if bh <= 0 or bh % 8:
        raise ValueError(f"bh={bh} must be a positive multiple of 8")
    y0, x0 = np.asarray(y0, np.int64), np.asarray(x0, np.int64)
    if y0.ndim != 1 or y0.shape != x0.shape:
        raise ValueError(f"y0 {y0.shape} and x0 {x0.shape} must be equal 1-D shapes")
    if len(y0):
        if x0.min() < 0 or x0.max() >= wp - LANES:
            raise ValueError(
                f"x0 in [{x0.min()}, {x0.max()}] breaks 0 <= x0 < Wp-128 = {wp - LANES}"
            )
        if y0.min() < 0 or y0.max() + bh > hp:
            raise ValueError(
                f"y0 in [{y0.min()}, {y0.max()}] breaks 0 <= y0, y0+bh <= Hp = {hp}"
            )
    return y0, x0


def window_index(y0: np.ndarray, x0: np.ndarray, bh: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(A, bh, 128) row and column indices of the windows."""
    rows = torch.as_tensor(y0, device=device)[:, None, None] + torch.arange(bh, device=device)[:, None]
    cols = torch.as_tensor(x0, device=device)[:, None, None] + torch.arange(LANES, device=device)
    return rows, cols


def window_gather_planes_plain(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`window_gather_planes`, on any
    device."""
    y0, x0 = _check(img, y0, x0, bh, planes=True)
    rows, cols = window_index(y0, x0, bh, img.device)
    return img[:, rows, cols].permute(1, 0, 2, 3).contiguous()


def window_gather_plain(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`window_gather`, on any device."""
    y0, x0 = _check(img, y0, x0, bh, planes=False)
    rows, cols = window_index(y0, x0, bh, img.device)
    return img[rows, cols]


def _launch(entry: str, img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, bh: int,
            out: torch.Tensor) -> None:
    """Launch ``entry`` on the current stream: ``img`` contiguous on the
    card, ``y0``/``x0`` (A,) int32 on the same card, ``out`` allocated."""
    from ..utils import cuda_build

    args = [img.data_ptr(), *img.shape, y0.data_ptr(), x0.data_ptr(), len(y0), bh,
            out.data_ptr(), torch.cuda.current_stream(img.device).cuda_stream]
    cuda_build.check(getattr(cuda_build.lib(), entry)(*args), f"{entry} kernel")


def _device_offsets(y0: np.ndarray, x0: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(y0.astype(np.int32)).to(device),
            torch.from_numpy(x0.astype(np.int32)).to(device))


def window_gather_planes(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """(A, P, bh, 128) windows of a (P, Hp, Wp) plane stack at host offsets
    ``y0``/``x0`` (A,), one window across all planes per reflection."""
    if img.device.type == "cpu":
        return window_gather_planes_plain(img, y0, x0, bh=bh)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    y0, x0 = _check(img, y0, x0, bh, planes=True)
    out = torch.empty((len(y0), img.shape[0], bh, LANES), dtype=img.dtype, device=img.device)
    _launch("ffs_window_gather_planes", img.contiguous(), *_device_offsets(y0, x0, img.device),
            bh, out)
    window_gather_planes.launches += 1
    return out


def window_gather(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """(A, bh, 128) windows of one (Hp, Wp) plane at host offsets
    ``y0``/``x0`` (A,)."""
    if img.device.type == "cpu":
        return window_gather_plain(img, y0, x0, bh=bh)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    y0, x0 = _check(img, y0, x0, bh, planes=False)
    out = torch.empty((len(y0), bh, LANES), dtype=img.dtype, device=img.device)
    _launch("ffs_window_gather", img.contiguous(), *_device_offsets(y0, x0, img.device), bh,
            out)
    window_gather.launches += 1
    return out


window_gather_planes.launches = 0
window_gather.launches = 0
