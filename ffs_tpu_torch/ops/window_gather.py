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

The TPU's gather variants have their counterparts here too, each with its
own kernel, plain version and counter, under the same contract checks:

* :func:`window_gather_planes_packed` (``_gather_planes_packed_kernel``):
  (A/4, P, bh, 128), lanes 32g..32g+31 of row i = columns 0..31 of window
  4i+g, i.e. ``window_gather_planes(...)[..., :32]`` relaid out; A % 4 == 0;
* :func:`window_gather_planes_pl` (``_gather_planes_pl_kernel``): the same
  windows as :func:`window_gather_planes` from a plane-last (Hp, Wp/128, P,
  128) source;
* :func:`window_gather_probe` (the kernel of ``make_probe_gather`` in
  ``tools/measure_window_gather.py``): the plane-first gather with ``r``
  windows per block, or with ``single_only`` the one-block rotate
  ``img[q, y0+r, 128*xblk + (c + shift) % 128]``, xblk = min(x0 // 128,
  Wp/128 - 2), shift = x0 - 128*xblk, the TPU probe's result.
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 128
DTYPES = (torch.int32, torch.float32)


def _check(img: torch.Tensor, y0, x0, bh: int, planes: bool):
    """Validate a gather's arguments against the contract; returns the host
    offsets as int64 arrays."""
    if img.dim() != (3 if planes else 2):
        want = "(P, Hp, Wp)" if planes else "(Hp, Wp)"
        raise ValueError(f"image must be {want}, got {tuple(img.shape)}")
    return _check_windows(img.dtype, *img.shape[-2:], y0, x0, bh)


def _check_windows(dtype: torch.dtype, hp: int, wp: int, y0, x0, bh: int):
    """The contract on a (Hp, Wp) plane's type, width and window offsets."""
    if dtype not in DTYPES:
        raise TypeError(f"window gathers take int32 or float32 images, got {dtype}")
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
            out: torch.Tensor, shape=None, extra=()) -> None:
    """Launch ``entry`` on the current stream: ``img`` contiguous on the
    card, ``y0``/``x0`` (A,) int32 on the same card, ``out`` allocated;
    ``shape`` the image dimensions the entry takes (default all of them),
    ``extra`` its int arguments after ``bh``."""
    from ..utils import cuda_build

    args = [img.data_ptr(), *(img.shape if shape is None else shape), y0.data_ptr(),
            x0.data_ptr(), len(y0), bh, *extra, out.data_ptr(),
            torch.cuda.current_stream(img.device).cuda_stream]
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




def pack_windows(windows: torch.Tensor) -> torch.Tensor:
    """(A, P, bh, >=32) windows -> (A/4, P, bh, 128): lanes 32g..32g+31 of
    row i hold columns 0..31 of window 4i+g."""
    a, p, bh = windows.shape[:3]
    return (windows[..., :32].reshape(a // 4, 4, p, bh, 32).permute(0, 2, 3, 1, 4)
            .reshape(a // 4, p, bh, LANES).contiguous())


def _check_packed(img, y0, x0, bh):
    y0, x0 = _check(img, y0, x0, bh, planes=True)
    if len(y0) % 4:
        raise ValueError(f"the packed gather needs a multiple of 4 windows, got {len(y0)}")
    return y0, x0


def window_gather_planes_packed_plain(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`window_gather_planes_packed`."""
    _check_packed(img, y0, x0, bh)
    return pack_windows(window_gather_planes_plain(img, y0, x0, bh=bh))


def window_gather_planes_packed(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """(A/4, P, bh, 128) lane-packed windows of a (P, Hp, Wp) plane stack:
    columns 0..31 of four windows a row, A a multiple of 4."""
    if img.device.type == "cpu":
        return window_gather_planes_packed_plain(img, y0, x0, bh=bh)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    y0, x0 = _check_packed(img, y0, x0, bh)
    out = torch.empty((len(y0) // 4, img.shape[0], bh, LANES), dtype=img.dtype,
                      device=img.device)
    _launch("ffs_window_gather_planes_packed", img.contiguous(),
            *_device_offsets(y0, x0, img.device), bh, out)
    window_gather_planes_packed.launches += 1
    return out


def _check_pl(img, y0, x0, bh):
    if img.dim() != 4 or img.shape[-1] != LANES:
        raise ValueError(f"plane-last image must be (Hp, Wp/128, P, 128), got {tuple(img.shape)}")
    hp, wb = img.shape[:2]
    return _check_windows(img.dtype, hp, wb * LANES, y0, x0, bh)


def window_gather_planes_pl_plain(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`window_gather_planes_pl`."""
    y0, x0 = _check_pl(img, y0, x0, bh)
    rows, cols = window_index(y0, x0, bh, img.device)
    # advanced indices split by a slice: the plane axis comes last
    return img[rows, cols // LANES, :, cols % LANES].permute(0, 3, 1, 2).contiguous()


def window_gather_planes_pl(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """(A, P, bh, 128) windows, equal to :func:`window_gather_planes`'s,
    from a plane-last (Hp, Wp/128, P, 128) source, e.g.
    ``frames.reshape(P, Hp, Wp // 128, 128).permute(1, 2, 0, 3)``."""
    if img.device.type == "cpu":
        return window_gather_planes_pl_plain(img, y0, x0, bh=bh)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    y0, x0 = _check_pl(img, y0, x0, bh)
    out = torch.empty((len(y0), img.shape[2], bh, LANES), dtype=img.dtype, device=img.device)
    _launch("ffs_window_gather_planes_pl", img.contiguous(),
            *_device_offsets(y0, x0, img.device), bh, out, shape=img.shape[:3])
    window_gather_planes_pl.launches += 1
    return out


def probe_columns(x0: np.ndarray, wp: int, single_only: bool) -> np.ndarray:
    """(A, 128) source columns of the probe's windows: x0 + c, or for the
    single-block form 128*xblk + (c + shift) % 128."""
    c = np.arange(LANES)
    if not single_only:
        return x0[:, None] + c
    xblk = np.minimum(x0 >> 7, wp // LANES - 2)
    shift = x0 - LANES * xblk
    return LANES * xblk[:, None] + (c + shift[:, None]) % LANES


def _check_probe(img, y0, x0, bh, r, slots):
    if r < 1 or slots < 2:
        raise ValueError(f"r={r} must be >= 1 and slots={slots} >= 2")
    return _check(img, y0, x0, bh, planes=True)


def window_gather_probe_plain(img: torch.Tensor, y0, x0, *, bh: int, single_only: bool = False,
                              r: int = 8, slots: int = 2) -> torch.Tensor:
    """The plain PyTorch version of :func:`window_gather_probe`."""
    y0, x0 = _check_probe(img, y0, x0, bh, r, slots)
    rows, _ = window_index(y0, x0, bh, img.device)
    cols = torch.as_tensor(probe_columns(x0, img.shape[-1], single_only), device=img.device)
    return img[:, rows, cols[:, None, :]].permute(1, 0, 2, 3).contiguous()


def window_gather_probe(img: torch.Tensor, y0, x0, *, bh: int, single_only: bool = False,
                        r: int = 8, slots: int = 2) -> torch.Tensor:
    """The measurement probe's (A, P, bh, 128) windows of a (P, Hp, Wp)
    stack.  ``r`` is the windows each CUDA block serves; ``slots``, the
    TPU probe's DMA pipeline depth, has no GPU counterpart and changes
    nothing (checked only to be >= 2, as the TPU's lookahead needs)."""
    if img.device.type == "cpu":
        return window_gather_probe_plain(img, y0, x0, bh=bh, single_only=single_only, r=r,
                                         slots=slots)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    y0, x0 = _check_probe(img, y0, x0, bh, r, slots)
    out = torch.empty((len(y0), img.shape[0], bh, LANES), dtype=img.dtype, device=img.device)
    _launch("ffs_window_gather_probe", img.contiguous(), *_device_offsets(y0, x0, img.device),
            bh, out, extra=(int(single_only), int(r)))
    window_gather_probe.launches += 1
    return out


window_gather_planes.launches = 0
window_gather.launches = 0
window_gather_planes_packed.launches = 0
window_gather_planes_pl.launches = 0
window_gather_probe.launches = 0
