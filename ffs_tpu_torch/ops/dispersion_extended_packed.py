"""Extended (erosion) dispersion -> packed strong words: CUDA kernel and
plain version.

Counterpart of
:func:`ffs_tpu.ops.dispersion_extended_pallas.dispersion_extended_packed_raw`:
the three extended stages (r=3 background test, Chebyshev-2 erosion, 11x11
background-mean test), then the [pc | w32] bit pack of
:mod:`ops.dispersion_packed` with ``nwl = nwl_for_width(W, HALO)`` (HALO = 10).

A CPU tensor takes the plain PyTorch version
:func:`dispersion_extended_packed_plain`; a CUDA tensor launches the kernel
in ``csrc/dispersion_extended_packed.cu`` (all three stages in one launch,
no intermediate plane, then the row scan) or raises.
``dispersion_extended_packed_raw.launches`` counts kernel launches.

:func:`dispersion_extended_fused` is the counterpart of
:func:`ffs_tpu.ops.dispersion_extended_pallas.dispersion_extended_fused`
(``_ext_kernel`` in rowcum mode): the same stages, emitted as a u8 strong
plane (unless ``emit_strong=False``) and the int32 per-row prefix count
``rowcum``, each (B?, H, W); ``dispersion_extended_fused.launches`` counts
its launches.
"""

from __future__ import annotations

import torch

from ..constants import (
    DEFAULT_MIN_COUNT,
    DEFAULT_NSIG_B,
    DEFAULT_NSIG_S,
    EROSION_CHEBYSHEV_DISTANCE,
    KERNEL_RADIUS,
    KERNEL_RADIUS_EXTENDED,
)

from . import dispersion as dops
from .dispersion_packed import (
    PIXEL_TYPES,
    _check_inputs,
    _cuda_args,
    _ptr,
    _stream,
    launch_tiling,
    mask_box_count,
    nwl_for_width,
    pack_pcw,
    rowcum_outputs,
)

# image halo of the fused stages: second-pass radius + erosion distance +
# first-pass radius (ffs_tpu.ops.dispersion_extended_pallas._IMG)
HALO = KERNEL_RADIUS_EXTENDED + EROSION_CHEBYSHEV_DISTANCE + KERNEL_RADIUS


def mask_box_count_extended(mask: torch.Tensor) -> torch.Tensor:
    """Frame-invariant first-pass mask box count, (H, W) u16.

    The JAX package keeps this on a padded strip canvas; the port keeps the
    plain (H, W) grid, the same array as :func:`mask_box_count`.  The
    kernel wrapper checks its shape against the mask and does not read it:
    the kernel counts the window from the mask bits it reads anyway.
    """
    return mask_box_count(mask, KERNEL_RADIUS)


def _strong_plain(image, mask, trusted_max, min_count, nsig_b, nsig_s):
    return dops.dispersion_extended(
        image, mask, trusted_max, min_count=min_count, nsig_b=nsig_b,
        nsig_s=nsig_s, dtype=torch.float32,
    )


def dispersion_extended_packed_plain(
    image: torch.Tensor,
    mask: torch.Tensor,
    trusted_max: float,
    *,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    nsig_s: float = DEFAULT_NSIG_S,
) -> torch.Tensor:
    """The kernels' plain PyTorch version, on any device: the float32
    ``ops.dispersion.dispersion_extended``, then ``pack_pcw``."""
    strong = _strong_plain(image, mask, trusted_max, min_count, nsig_b, nsig_s)
    return pack_pcw(strong, nwl_for_width(image.shape[-1], HALO))


def dispersion_extended_packed_raw(
    image: torch.Tensor,
    mask: torch.Tensor,
    trusted_max: float,
    *,
    mbox: torch.Tensor | None = None,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    nsig_s: float = DEFAULT_NSIG_S,
) -> torch.Tensor:
    """Extended dispersion -> (B?, H, 2*nwl) int32 [pc | w32] rows.

    ``image`` (H, W) or (B, H, W) uint16, uint32 or int32; ``mask`` (H, W) uint8;
    ``mbox`` the optional :func:`mask_box_count_extended`, checked for shape
    and not read (an integer window count the kernel takes from the mask
    bits it reads anyway, at no device-memory cost).
    """
    _check_inputs(image, mask, mbox)
    if image.device.type == "cpu":
        return dispersion_extended_packed_plain(
            image, mask, trusted_max, min_count=min_count, nsig_b=nsig_b,
            nsig_s=nsig_s,
        )
    if image.device.type != "cuda":
        raise ValueError(f"no kernel for device {image.device}")

    from ..utils import cuda_build

    frames, mask_c = _cuda_args(image, mask, mbox)
    b, h, w = frames.shape
    nwl = nwl_for_width(w, HALO)
    tiling = launch_tiling(frames, HALO, True, False)
    out = torch.empty((b, h, 2 * nwl), dtype=torch.int32, device=image.device)
    with torch.cuda.device(image.device):
        rc = cuda_build.lib().ffs_dispersion_extended_packed(
            frames.data_ptr(), PIXEL_TYPES[frames.dtype], mask_c.data_ptr(), out.data_ptr(),
            b, h, w, nwl, tiling.wps, tiling.seg_rows, float(trusted_max), int(min_count),
            float(nsig_b), float(nsig_s), _stream(image.device),
        )
    dispersion_extended_packed_raw.launches += 1
    cuda_build.check(rc, "dispersion_extended_packed kernel")
    return out if image.dim() == 3 else out[0]


dispersion_extended_packed_raw.launches = 0


def dispersion_extended_fused_plain(
    image: torch.Tensor,
    mask: torch.Tensor,
    trusted_max: float,
    *,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    nsig_s: float = DEFAULT_NSIG_S,
    emit_strong: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """The fused entry's plain PyTorch version, on any device: the float32
    ``ops.dispersion.dispersion_extended``, then a row ``cumsum``."""
    strong = _strong_plain(image, mask, trusted_max, min_count, nsig_b, nsig_s)
    return rowcum_outputs(strong, emit_strong)


def dispersion_extended_fused(
    image: torch.Tensor,
    mask: torch.Tensor,
    trusted_max: float,
    *,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    nsig_s: float = DEFAULT_NSIG_S,
    emit_strong: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Extended dispersion -> (strong u8 or None, rowcum int32), each shaped
    like ``image``, (H, W) or (B, H, W).  Like the JAX entry it takes no
    mask box count: the first pass sums the mask itself (integer window
    sums, exact in any order).  ``emit_strong=False`` writes no strong
    plane and returns (None, rowcum)."""
    _check_inputs(image, mask, None)
    if image.device.type == "cpu":
        return dispersion_extended_fused_plain(
            image, mask, trusted_max, min_count=min_count, nsig_b=nsig_b,
            nsig_s=nsig_s, emit_strong=emit_strong,
        )
    if image.device.type != "cuda":
        raise ValueError(f"no kernel for device {image.device}")

    from ..utils import cuda_build

    frames, mask_c = _cuda_args(image, mask, None)
    b, h, w = frames.shape
    nwl = nwl_for_width(w, HALO)
    tiling = launch_tiling(frames, HALO, True, False)
    dev = image.device
    pcw = torch.empty((b, h, 2 * nwl), dtype=torch.int32, device=dev)
    strong = torch.empty((b, h, w), dtype=torch.uint8, device=dev) if emit_strong else None
    rowcum = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_build.lib().ffs_dispersion_extended_fused(
            frames.data_ptr(), PIXEL_TYPES[frames.dtype], mask_c.data_ptr(), pcw.data_ptr(),
            _ptr(strong), rowcum.data_ptr(), b, h, w, nwl, tiling.wps, tiling.seg_rows,
            float(trusted_max), int(min_count), float(nsig_b), float(nsig_s), _stream(dev),
        )
    dispersion_extended_fused.launches += 1
    cuda_build.check(rc, "dispersion_extended_fused kernels")
    if image.dim() == 2:
        return (None if strong is None else strong[0]), rowcum[0]
    return strong, rowcum


dispersion_extended_fused.launches = 0
