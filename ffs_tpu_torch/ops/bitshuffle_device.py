"""Bitshuffle planes -> row-major frames on the device, and the whole chunk
decode: CUDA kernel and plain version.

Counterpart of :mod:`ffs_tpu.ops.bitshuffle_device` (the inverse bitshuffle
of the LZ4-decoded block planes) and :mod:`ffs_tpu.ops.frame_assemble` (the
flat stream -> ``(B, H, W)`` frame relayout).  On the TPU the two are
separate programs because the detector width is not lane-aligned there; on
the GPU a row-major frame is the flat element stream itself, so one kernel
does the whole composition the batched decode path runs:

    frames_from_planes(planes, H, W, dtype)[b] ==
        untranspose(planes[b]).reshape(-1)[:H*W].reshape(H, W)

Bitshuffle block layout (upstream ``bshuf_trans_bit_elem`` framing, as
``io/compression.py`` writes it): a block of n8 elements (n8 % 8 == 0) of
S bytes is an (S, 8, n8/8)-byte array whose byte [s, kk, m] holds bit kk of
byte s of elements 8m..8m+7, bit t of that byte belonging to element 8m+t.
The final partial block of a frame arrives re-spread into the full-block
layout with zero padding (``compression.bshuf_lz4_planes``); elements at or
past H*W are dropped.

:func:`frames_from_planes` picks by the planes tensor's device: a CPU tensor
takes the plain PyTorch version, a CUDA tensor launches the kernel in
``csrc/bitshuffle_frames.cu`` or raises; there is no fallback between the
two.  :func:`untranspose_planes` is the same kernel over a chunk's blocks
(any element size of 1, 2 or 4 bytes), and :func:`decode_blocks` and
:func:`bshuf_lz4_decompress_device` decode a whole chunk through it, as the
JAX package's functions of those names do.  ``frames_from_planes.launches``
counts the kernel's launches from either entry.
"""

from __future__ import annotations

import numpy as np
import torch

_UNSIGNED = {1: torch.uint8, 2: torch.uint16, 4: torch.uint32}
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def _transpose8(r):
    """8x8 bit-matrix transpose of 8 byte planes (int64 tensors holding one
    byte each): returns (x, y) whose byte t (x: t=0..3, y: t=4..7) has bit
    kk = bit t of r[kk].  The three delta-swap steps of
    ``ffs_tpu.ops.bitshuffle_device._transpose8``; int64 keeps every
    intermediate of the u32 arithmetic non-negative and exact."""
    x = r[0] | (r[1] << 8) | (r[2] << 16) | (r[3] << 24)
    y = r[4] | (r[5] << 8) | (r[6] << 16) | (r[7] << 24)

    def step(w, sh, mask):
        t = (w ^ (w >> sh)) & mask
        return w ^ t ^ (t << sh)

    x, y = step(x, 7, 0x00AA00AA), step(y, 7, 0x00AA00AA)
    x, y = step(x, 14, 0x0000CCCC), step(y, 14, 0x0000CCCC)
    t = (x ^ (y << 4)) & 0xF0F0F0F0
    return x ^ t, y ^ (t >> 4)


def _to_unsigned(values: torch.Tensor, elem_size: int) -> torch.Tensor:
    """int64 tensor of unsigned ``8*elem_size``-bit values -> the unsigned
    dtype, through the same-width signed type (PyTorch's uint16/uint32 lack
    most ops)."""
    bits = 8 * elem_size
    signed = torch.where(values >= 1 << (bits - 1), values - (1 << bits), values)
    return signed.to(_SIGNED[elem_size]).view(_UNSIGNED[elem_size])


def _check_blocks(planes: torch.Tensor, elem_size: int) -> None:
    """The untranspose's guards: (n_blocks, block_bytes) uint8 planes of
    whole 8-element groups of 1, 2 or 4 bytes."""
    if elem_size not in _UNSIGNED:
        raise ValueError(f"elem_size must be 1, 2 or 4, got {elem_size}")
    if planes.dtype != torch.uint8 or planes.dim() != 2:
        raise ValueError(f"planes must be (n_blocks, block_bytes) uint8, got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    if planes.shape[1] % (8 * elem_size):
        raise ValueError(
            f"block of {planes.shape[1]} bytes is not a whole number of "
            f"8-element groups at elem_size {elem_size}"
        )


def untranspose_planes_plain(planes: torch.Tensor, elem_size: int, out_dtype=None) -> torch.Tensor:
    """Inverse bitshuffle of stacked equal-size blocks, in plain PyTorch on
    any device.

    ``planes``: (n_blocks, block_elem * elem_size) uint8.  Returns
    (n_blocks, block_elem) of ``out_dtype`` (default, and the only one
    taken: the unsigned type of ``elem_size`` bytes).
    """
    _check_blocks(planes, elem_size)
    if out_dtype is not None and out_dtype != _UNSIGNED[elem_size]:
        raise TypeError(f"elem_size {elem_size} gives {_UNSIGNED[elem_size]}, not {out_dtype}")
    n_blocks, block_bytes = planes.shape
    m = block_bytes // (8 * elem_size)  # 8-element groups per block
    p = planes.reshape(n_blocks, elem_size, 8, m).to(torch.int64)
    shifts = 8 * torch.arange(8, dtype=torch.int64, device=planes.device)
    values = torch.zeros((n_blocks, m, 8), dtype=torch.int64, device=planes.device)
    for s in range(elem_size):
        x, y = _transpose8([p[:, s, kk] for kk in range(8)])
        xy = x | (y << 32)  # byte t = byte s of element 8m+t
        values |= ((xy[..., None] >> shifts) & 0xFF) << (8 * s)
    return _to_unsigned(values.reshape(n_blocks, m * 8), elem_size)


def check_planes(shape, height: int, width: int, elem_size: int) -> None:
    """The decode path's guards (``ffs_tpu.spotfind.dispatch_batch_planes``):
    (B, n_blocks, block_elem * elem_size) planes that hold a whole frame of
    a multiple-of-8 pixel count."""
    n_px = height * width
    if n_px % 8:
        raise ValueError(f"device decode needs a multiple-of-8 pixel count, got {n_px}")
    if len(shape) != 3:
        raise ValueError(f"planes must be (B, n_blocks, block_bytes), got {tuple(shape)}")
    held = shape[1] * (shape[2] // elem_size)
    if held < n_px:
        raise ValueError(f"planes hold {held} elements < frame size {n_px}")
    if shape[2] % (8 * elem_size):
        raise ValueError(
            f"block of {shape[2]} bytes is not a whole number of "
            f"8-element groups at elem_size {elem_size}"
        )


def frames_from_planes_plain(planes: torch.Tensor, height: int, width: int,
                             dtype: torch.dtype) -> torch.Tensor:
    """The plain PyTorch version of :func:`frames_from_planes`, on any
    device."""
    elem_size = _elem_size(dtype)
    check_planes(planes.shape, height, width, elem_size)
    b, n_blocks, block_bytes = planes.shape
    elems = untranspose_planes_plain(planes.reshape(b * n_blocks, block_bytes), elem_size)
    return elems.reshape(b, -1)[:, : height * width].reshape(b, height, width)


def _elem_size(dtype: torch.dtype) -> int:
    if dtype not in (torch.uint16, torch.uint32):
        raise TypeError(f"frames are uint16 or uint32, got {dtype}")
    return 2 if dtype == torch.uint16 else 4


def frames_from_planes(planes: torch.Tensor, height: int, width: int,
                       dtype: torch.dtype) -> torch.Tensor:
    """(B, n_blocks, block_elem * S) uint8 bitshuffle planes -> (B, H, W)
    ``dtype`` frames (uint16: S = 2, uint32: S = 4).

    ``block_elem`` is whatever the planes' shape says (any multiple of 8;
    the chunk header sets it).  Raises on the guards of
    :func:`check_planes`.
    """
    if planes.dtype != torch.uint8:
        raise TypeError(f"planes must be uint8, got {planes.dtype}")
    if planes.device.type == "cpu":
        return frames_from_planes_plain(planes, height, width, dtype)
    if planes.device.type != "cuda":
        raise ValueError(f"no kernel for device {planes.device}")
    elem_size = _elem_size(dtype)
    check_planes(planes.shape, height, width, elem_size)
    out = torch.empty((planes.shape[0], height, width), dtype=dtype, device=planes.device)
    return _launch(planes, elem_size, height * width, out)


frames_from_planes.launches = 0


def _launch(planes: torch.Tensor, elem_size: int, n_px: int, out: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/bitshuffle_frames.cu`` on CUDA planes (B, n_blocks,
    block_bytes) uint8 into ``out``, (B, n_px) elements of ``elem_size``
    bytes, the guards already checked; the one place that counts a launch
    (``frames_from_planes.launches``)."""
    from ..utils import cuda_build

    if n_px >= 2**31:
        raise ValueError(f"{n_px} elements overflow the kernel's int count")
    planes = planes.contiguous()
    b, n_blocks, block_bytes = planes.shape
    if b == 0 or n_px == 0:
        return out
    with torch.cuda.device(planes.device):
        rc = cuda_build.lib().ffs_bitshuffle_frames(
            planes.data_ptr(), b, n_blocks, block_bytes // elem_size, elem_size, n_px,
            out.data_ptr(), torch.cuda.current_stream(planes.device).cuda_stream,
        )
    frames_from_planes.launches += 1
    cuda_build.check(rc, "bitshuffle_frames kernel")
    return out


def untranspose_planes(planes: torch.Tensor, elem_size: int) -> torch.Tensor:
    """Inverse bitshuffle of stacked equal-size blocks: (n_blocks,
    block_elem * elem_size) uint8 -> (n_blocks, block_elem) of the unsigned
    type of ``elem_size`` bytes (1, 2 or 4).

    A CPU tensor takes :func:`untranspose_planes_plain`; a CUDA tensor
    launches the kernel of :func:`frames_from_planes` with the blocks as one
    flat frame (one kernel, one count); any other device raises.
    """
    if planes.device.type == "cpu":
        return untranspose_planes_plain(planes, elem_size)
    if planes.device.type != "cuda":
        raise ValueError(f"no kernel for device {planes.device}")
    _check_blocks(planes, elem_size)
    n_blocks, block_bytes = planes.shape
    block_elem = block_bytes // elem_size
    out = torch.empty((n_blocks, block_elem), dtype=_UNSIGNED[elem_size], device=planes.device)
    return _launch(planes[None], elem_size, n_blocks * block_elem, out)


def decode_blocks(planes, elem_size: int, out_dtype=None,
                  device: torch.device | None = None) -> torch.Tensor:
    """Untranspose a (n_blocks, block_bytes) uint8 plane matrix on the
    device -> (n_blocks, block_elem) elements, left there: the unsigned type
    of ``elem_size`` bytes, or ``out_dtype`` (a torch or NumPy dtype) where
    given, as JAX's function makes it: bytes cast by value, wider elements
    reinterpreted as a type of their width (any other raises ValueError).
    A host array goes to ``device`` (default:
    ``utils.torchinit.select_device()``, the card unless
    FFS_TORCH_DEVICE=cpu); a tensor stays where it is.  The counterpart of
    ``ffs_tpu.ops.bitshuffle_device.decode_blocks``."""
    if not isinstance(planes, torch.Tensor):
        if device is None:
            from ..utils.torchinit import select_device

            device = select_device()
        planes = torch.from_numpy(np.ascontiguousarray(planes)).to(device)
    out = untranspose_planes(planes, elem_size)
    if out_dtype is None:
        return out
    if not isinstance(out_dtype, torch.dtype):
        out_dtype = torch.from_numpy(np.empty(0, np.dtype(out_dtype))).dtype
    if elem_size == 1:
        return out.to(out_dtype)
    if out_dtype.itemsize != elem_size:
        raise ValueError(f"{elem_size}-byte elements cannot be read as {out_dtype}")
    return out.view(out_dtype)


def bshuf_lz4_decompress_device(chunk: bytes, n_elem: int, elem_size: int,
                                skip_header: bool = True,
                                device: torch.device | None = None) -> np.ndarray:
    """Whole filter-32008 chunk decode with the untranspose on the device:
    LZ4 per block on the host (``io.compression.bshuf_lz4_planes``), the bit
    untranspose by :func:`decode_blocks`, the raw tail of ``n_elem % 8``
    elements appended on the host.  Returns a host uint8 buffer bit-identical
    to ``io.compression.bshuf_lz4_decompress``.  The counterpart of
    ``ffs_tpu.ops.bitshuffle_device.bshuf_lz4_decompress_device``."""
    from ..io.compression import bshuf_lz4_planes

    planes, tail, _block_elem, n_shuf = bshuf_lz4_planes(
        chunk, n_elem, elem_size, skip_header=skip_header
    )
    out = np.empty(n_elem * elem_size, dtype=np.uint8)
    if n_shuf:
        elems = decode_blocks(planes, elem_size, device=device)
        flat = elems.view(torch.uint8).reshape(-1)[: n_shuf * elem_size]
        out[: n_shuf * elem_size] = flat.cpu().numpy()
    if len(tail):
        out[n_shuf * elem_size :] = np.frombuffer(tail, np.uint8)
    return out


def planes_to_frame_host(planes: np.ndarray, n_elem: int, elem_size: int) -> np.ndarray:
    """Host untranspose of a (n_blocks, block_bytes) plane matrix (the CLI's
    mixed-batch fallback): NumPy bit decode per padded block, sliced to
    ``n_elem`` elements.  Returns the flat uint8 element buffer.  A copy of
    ``ffs_tpu.ops.bitshuffle_device.planes_to_frame_host``."""
    from ..io.compression import bitshuffle_decode_np

    n_blocks, block_bytes = planes.shape
    block_elem = block_bytes // elem_size
    out = np.empty(n_elem * elem_size, dtype=np.uint8)
    for b in range(n_blocks):
        lo = b * block_elem * elem_size
        hi = min((b + 1) * block_elem * elem_size, n_elem * elem_size)
        if hi <= lo:
            break
        dec = bitshuffle_decode_np(planes[b], block_elem, elem_size)
        out[lo:hi] = dec[: hi - lo]
    return out
