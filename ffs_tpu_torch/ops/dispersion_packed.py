"""Dispersion threshold -> packed strong words: CUDA kernel and plain version.

Counterpart of :func:`ffs_tpu.ops.dispersion_pallas.dispersion_packed_raw`
and its ``_pack_pcw`` bit pack.  The output is the combined-row contract the
compaction stages read, one (B?, H, 2*nwl) int32 array with lanes [pc | w32]:

* ``w32[..., h, j]`` packs the strong flags of columns 32j..32j+31 (bit t =
  column 32j+t) as an int32 bit pattern, so bit 31 makes a word negative;
  words past the image width are zero;
* ``pc[..., h, j]`` is the inclusive count of strong pixels in row h
  through word j, so ``pc[..., h, nwl-1]`` is the row total.

``nwl = nwl_for_width(W)`` exactly as on the JAX side, because
the host compaction (ops.compact_host) reads the same array.

:func:`dispersion_packed_raw` picks by the image tensor's device: a CPU
tensor takes the plain PyTorch version :func:`dispersion_packed_plain`
(``ops.dispersion`` in float32, then :func:`pack_pcw`); a CUDA tensor
launches the kernel in ``csrc/dispersion_packed.cu`` (a row walker, tiled
by :func:`walker_tiling`, then the row scan) or raises.  There is no
fallback between the two.  ``dispersion_packed_raw.launches`` counts kernel
launches.

:func:`dispersion_fused` is the counterpart of
:func:`ffs_tpu.ops.dispersion_pallas.dispersion_fused`: the same predicate
emitted densely, a u8 strong plane (unless ``emit_strong=False``) and the
int32 ``rowcum``, the inclusive per-row prefix count of strong pixels, each
(B?, H, W).  Its CUDA route runs the packed kernel into scratch rows and
expands them (``ffs_dispersion_fused`` in ``csrc/dispersion_packed.cu``);
``dispersion_fused.launches`` counts its launches.  :func:`dispersion_packed`
splits the combined rows into ``(w32, pc)`` as the JAX wrapper does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..constants import (
    DEFAULT_MIN_COUNT,
    DEFAULT_NSIG_B,
    DEFAULT_NSIG_S,
    KERNEL_RADIUS,
)

from . import dispersion as dops
from .dispersion import box_sum


def nwl_for_width(w: int, halo: int = KERNEL_RADIUS) -> int:
    """Word lanes of the packed output for an image ``w`` columns wide whose
    kernel pads each side by ``halo`` columns (3 dispersion, 10 extended):
    ceil(wp/32) rounded up to 8 lanes, wp = the padded width rounded up to
    128 (ffs_tpu.ops.dispersion_pallas._n_word_lanes)."""
    wp = ((w + 2 * halo + 127) // 128) * 128
    return ((wp // 32 + 7) // 8) * 8


def mask_box_count(mask: torch.Tensor, radius: int = KERNEL_RADIUS) -> torch.Tensor:
    """Per-pixel count of valid mask pixels in the (2r+1)^2 window, as u16:
    the frame-invariant ``mbox`` of the JAX entries.  The CUDA kernels take
    it for that signature's sake and do not read it (see
    :func:`dispersion_packed_raw`)."""
    counts = box_sum((mask != 0).to(torch.int32), radius)
    return counts.to(torch.int16).view(torch.uint16)  # counts <= (2r+1)^2


def pack_pcw(strong: torch.Tensor, nwl: int) -> torch.Tensor:
    """Dense bool strong plane (..., H, W) -> combined [pc | w32] int32 rows."""
    w = strong.shape[-1]
    need = nwl * 32
    if w > need:
        raise ValueError(f"width {w} needs more than {nwl} word lanes")
    bits = torch.nn.functional.pad(strong.to(torch.int64), (0, need - w))
    bits = bits.reshape(*strong.shape[:-1], nwl, 32)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=strong.device),
        torch.arange(32, dtype=torch.int64, device=strong.device),
    )
    words = (bits * weights).sum(dim=-1)
    # int64 -> int32 keeps the low 32 bits: the i32 bit pattern of the word
    w32 = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    pc = torch.cumsum(bits.sum(dim=-1), dim=-1).to(torch.int32)
    return torch.cat([pc, w32], dim=-1)


# pixel_type codes of the C entry points (csrc/common.cuh PixelType)
PIXEL_TYPES = {torch.uint16: 0, torch.uint32: 1, torch.int32: 2}

# The row walker of csrc/common.cuh: a block owns a strip of words and a
# segment of rows, which it walks down after a warm-up of twice the kernel's
# halo rows.  The library sets the widest strip
# (ffs_walker_max_strip_words) and the threads a block.


class WalkerTiling(NamedTuple):
    wps: int  # words a strip
    strips: int
    seg_rows: int  # rows a segment (the last may be shorter)
    segs: int


def strip_words(w: int, max_words: int) -> tuple[int, int]:
    """(words a strip, strips): equal strips of at most ``max_words``
    covering the ceil(w/32) words."""
    words = -(-w // 32)
    strips = -(-words // max_words)
    return -(-words // strips), strips


@functools.lru_cache(maxsize=256)
def walker_tiling(b: int, h: int, w: int, halo: int, slots: int, max_words: int) -> WalkerTiling:
    """The walker kernels' grid for ``b`` frames of ``h`` x ``w`` with a
    ``halo``-row warm-up above and below each segment, strips of at most
    ``max_words`` words, on a card that holds ``slots`` blocks at once.  The
    segment count minimises the modelled time, waves x (rows a segment + 2
    halo), so that the grid fills whole waves without paying too much
    warm-up; a segment is at least 2 halo rows tall unless it is the whole
    frame.  Block (s, g, f) writes words [s*wps, min((s+1)*wps, ceil(w/32)))
    of rows [g*seg_rows, min((g+1)*seg_rows, h)) of frame f."""
    wps, strips = strip_words(w, max_words)
    best = None
    for segs in range(1, h + 1):
        seg_rows = -(-h // segs)
        if -(-h // seg_rows) != segs:  # the same segments as a smaller count
            continue
        if segs > 1 and seg_rows < 2 * halo:
            break
        cost = -(-(strips * b * segs) // slots) * (seg_rows + 2 * halo)
        if best is None or cost < best[0]:
            best = (cost, seg_rows, segs)
    return WalkerTiling(wps, strips, best[1], best[2])


@functools.lru_cache(maxsize=64)
def walker_slots(extended: bool, pixel_type: int, signal_test: bool, wps: int,
                 device_index: int) -> int:
    """Walker blocks the card ``device_index`` holds at once for strips of
    ``wps`` words: the kernel's resident blocks a multiprocessor (CUDA's
    occupancy query, on that card) times its multiprocessors."""
    from ..utils import cuda_build

    lib = cuda_build.lib()
    with torch.cuda.device(device_index):
        if extended:
            per_sm = lib.ffs_extended_walker_blocks_per_sm(pixel_type, wps)
        else:
            per_sm = lib.ffs_dispersion_walker_blocks_per_sm(pixel_type, int(signal_test), wps)
    if per_sm < 1:
        raise RuntimeError(f"walker occupancy query failed ({per_sm}) for {wps}-word strips")
    return per_sm * torch.cuda.get_device_properties(device_index).multi_processor_count


def launch_tiling(frames: torch.Tensor, halo: int, extended: bool,
                  signal_test: bool) -> WalkerTiling:
    """The tiling a walker launch uses for these (B, H, W) CUDA frames."""
    from ..utils import cuda_build

    b, h, w = frames.shape
    dev = frames.device.index if frames.device.index is not None else torch.cuda.current_device()
    max_words = cuda_build.lib().ffs_walker_max_strip_words()
    wps = strip_words(w, max_words)[0]
    slots = walker_slots(extended, PIXEL_TYPES[frames.dtype], signal_test, wps, dev)
    return walker_tiling(b, h, w, halo, slots, max_words)


def _check_inputs(image, mask, mbox):
    if image.dtype not in PIXEL_TYPES:
        raise TypeError(f"image must be uint16, uint32 or int32, got {image.dtype}")
    if image.dim() not in (2, 3):
        raise ValueError(f"image must be (H, W) or (B, H, W), got {tuple(image.shape)}")
    if tuple(mask.shape) != tuple(image.shape[-2:]):
        raise ValueError(
            f"mask shape {tuple(mask.shape)} != frame shape {tuple(image.shape[-2:])}"
        )
    if mbox is not None and tuple(mbox.shape) != tuple(mask.shape):
        raise ValueError(
            f"mbox shape {tuple(mbox.shape)} != mask shape {tuple(mask.shape)}; "
            "build it with mask_box_count(mask)"
        )


def _cuda_args(image, mask, mbox):
    """Validate a kernel call's tensors; returns (frames (B,H,W), mask)."""
    dev = image.device
    for name, t in (("mask", mask), ("mbox", mbox)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, image on {dev}")
    if mask.dtype != torch.uint8:
        raise TypeError(f"mask must be uint8 for the kernel, got {mask.dtype}")
    if mbox is not None and mbox.dtype != torch.uint16:
        raise TypeError(f"mbox must be uint16, got {mbox.dtype}")
    frames = image if image.dim() == 3 else image[None]
    return frames.contiguous(), mask.contiguous()


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    """The current stream of ``dev``; the caller launches under
    ``torch.cuda.device(dev)``, so the kernel runs on the tensors' card."""
    return torch.cuda.current_stream(dev).cuda_stream


def _strong_plain(image, mask, trusted_max, min_count, nsig_b, nsig_s, signal_test):
    """The float32 threshold of ``ops.dispersion`` (bool, image's shape)."""
    if signal_test:
        return dops.dispersion(
            image, mask, trusted_max, min_count=min_count, nsig_b=nsig_b,
            nsig_s=nsig_s, dtype=torch.float32,
        )
    return dops.dispersion_first_pass(
        image, mask, trusted_max, min_count=min_count, nsig_b=nsig_b,
        dtype=torch.float32,
    )


def dispersion_packed_plain(
    image: torch.Tensor,
    mask: torch.Tensor,
    trusted_max: float,
    *,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    nsig_s: float = DEFAULT_NSIG_S,
    signal_test: bool = True,
) -> torch.Tensor:
    """The kernel's plain PyTorch version, on any device: the float32
    threshold of ``ops.dispersion``, then :func:`pack_pcw`."""
    strong = _strong_plain(image, mask, trusted_max, min_count, nsig_b, nsig_s, signal_test)
    return pack_pcw(strong, nwl_for_width(image.shape[-1]))


def rowcum_outputs(strong: torch.Tensor, emit_strong: bool):
    """Dense bool strong plane -> (strong u8 or None, inclusive per-row
    prefix count int32), the outputs of the fused (rowcum) entries."""
    rowcum = torch.cumsum(strong, dim=-1, dtype=torch.int32)
    return (strong.to(torch.uint8) if emit_strong else None), rowcum


def dispersion_packed_raw(
    image: torch.Tensor,
    mask: torch.Tensor,
    trusted_max: float,
    *,
    mbox: torch.Tensor | None = None,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    nsig_s: float = DEFAULT_NSIG_S,
    signal_test: bool = True,
) -> torch.Tensor:
    """Dispersion threshold -> (B?, H, 2*nwl) int32 [pc | w32] rows.

    ``image`` (H, W) or (B, H, W) uint16, uint32 or int32 (CBF data);
    ``mask`` (H, W) uint8; ``mbox`` the optional frame-invariant
    :func:`mask_box_count`, checked for shape and not read: the kernel
    counts the 7x7 mask window itself from the mask it reads anyway (an
    integer sum, exact in any order), which costs no device-memory bytes,
    where reading the u16 count cost 36 MB an Eiger 16M frame.
    ``signal_test=False`` gives the extended algorithm's first pass.
    """
    _check_inputs(image, mask, mbox)
    if image.device.type == "cpu":
        return dispersion_packed_plain(
            image, mask, trusted_max, min_count=min_count, nsig_b=nsig_b,
            nsig_s=nsig_s, signal_test=signal_test,
        )
    if image.device.type != "cuda":
        raise ValueError(f"no kernel for device {image.device}")

    from ..utils import cuda_build

    frames, mask_c = _cuda_args(image, mask, mbox)
    b, h, w = frames.shape
    nwl = nwl_for_width(w)
    tiling = launch_tiling(frames, KERNEL_RADIUS, False, signal_test)
    out = torch.empty((b, h, 2 * nwl), dtype=torch.int32, device=image.device)
    with torch.cuda.device(image.device):
        rc = cuda_build.lib().ffs_dispersion_packed(
            frames.data_ptr(), PIXEL_TYPES[frames.dtype], mask_c.data_ptr(),
            out.data_ptr(), b, h, w, nwl, tiling.wps, tiling.seg_rows, float(trusted_max),
            int(min_count), float(nsig_b), float(nsig_s), int(signal_test),
            _stream(image.device),
        )
    dispersion_packed_raw.launches += 1
    cuda_build.check(rc, "dispersion_packed kernel")
    return out if image.dim() == 3 else out[0]


dispersion_packed_raw.launches = 0


def dispersion_packed(
    image: torch.Tensor,
    mask: torch.Tensor,
    trusted_max: float,
    **kwargs,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`dispersion_packed_raw` split into ``(w32, pc)``, each
    (B?, H, nwl): lane slices of the combined rows, no kernel of its own."""
    pcw = dispersion_packed_raw(image, mask, trusted_max, **kwargs)
    nwl = pcw.shape[-1] // 2
    return pcw[..., nwl:], pcw[..., :nwl]


def dispersion_fused_plain(
    image: torch.Tensor,
    mask: torch.Tensor,
    trusted_max: float,
    *,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    nsig_s: float = DEFAULT_NSIG_S,
    signal_test: bool = True,
    emit_strong: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """The fused entry's plain PyTorch version, on any device: the float32
    threshold of ``ops.dispersion``, then a row ``cumsum``."""
    strong = _strong_plain(image, mask, trusted_max, min_count, nsig_b, nsig_s, signal_test)
    return rowcum_outputs(strong, emit_strong)


def dispersion_fused(
    image: torch.Tensor,
    mask: torch.Tensor,
    trusted_max: float,
    *,
    mbox: torch.Tensor | None = None,
    min_count: int = DEFAULT_MIN_COUNT,
    nsig_b: float = DEFAULT_NSIG_B,
    nsig_s: float = DEFAULT_NSIG_S,
    radius: int = KERNEL_RADIUS,
    signal_test: bool = True,
    emit_strong: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Dispersion threshold -> (strong u8 or None, rowcum int32), each
    shaped like ``image``, (H, W) or (B, H, W).

    ``rowcum[..., y, x]`` counts the strong pixels of row y through column
    x.  ``signal_test=False`` gives the extended algorithm's first pass;
    ``emit_strong=False`` writes no strong plane and returns (None, rowcum).
    The JAX entry's ``strip`` tiles VMEM and does not change the result, so
    the port takes none; ``radius`` must be 3, as the TPU's 7-wide trees.
    """
    if radius != KERNEL_RADIUS:
        raise ValueError(f"radius={radius}: the fused kernel's window trees are 7 wide (radius 3)")
    _check_inputs(image, mask, mbox)
    if image.device.type == "cpu":
        return dispersion_fused_plain(
            image, mask, trusted_max, min_count=min_count, nsig_b=nsig_b,
            nsig_s=nsig_s, signal_test=signal_test, emit_strong=emit_strong,
        )
    if image.device.type != "cuda":
        raise ValueError(f"no kernel for device {image.device}")

    from ..utils import cuda_build

    frames, mask_c = _cuda_args(image, mask, mbox)
    b, h, w = frames.shape
    nwl = nwl_for_width(w)
    tiling = launch_tiling(frames, KERNEL_RADIUS, False, signal_test)
    dev = image.device
    pcw = torch.empty((b, h, 2 * nwl), dtype=torch.int32, device=dev)
    strong = torch.empty((b, h, w), dtype=torch.uint8, device=dev) if emit_strong else None
    rowcum = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_build.lib().ffs_dispersion_fused(
            frames.data_ptr(), PIXEL_TYPES[frames.dtype], mask_c.data_ptr(),
            pcw.data_ptr(), _ptr(strong), rowcum.data_ptr(), b, h, w, nwl,
            tiling.wps, tiling.seg_rows, float(trusted_max), int(min_count), float(nsig_b),
            float(nsig_s), int(signal_test), _stream(dev),
        )
    dispersion_fused.launches += 1
    cuda_build.check(rc, "dispersion_fused kernels")
    if image.dim() == 2:
        return (None if strong is None else strong[0]), rowcum[0]
    return strong, rowcum


dispersion_fused.launches = 0
