"""The port's device bitshuffle decode (ffs_tpu_torch.ops.bitshuffle_device)
against ffs_tpu's untranspose and frame-assembly kernels, bit for bit.

The JAX side runs its Pallas frame-assembly kernel in interpret mode on the
CPU, as its own tests do; the port's ``frames_from_planes`` takes its plain
PyTorch version for CPU tensors.  The planes come from the port's own
codec (``bshuf_lz4_compress`` then ``bshuf_lz4_planes``), so every frame
whose pixel count is not a multiple of the block size ends in a partial
block re-spread into the full-block layout.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffs_tpu.ops import bitshuffle_device as jbd
from ffs_tpu.ops.frame_assemble import frames_from_flat_wide
from ffs_tpu_torch.io import compression
from ffs_tpu_torch.ops import bitshuffle_device as tbd


def _frame(h, w, dtype, seed):
    rng = np.random.default_rng(seed)
    top = 60000 if dtype == np.uint16 else 2**32 - 1
    frame = rng.poisson(3.0, size=(h, w)).astype(dtype)
    hot = rng.random((h, w)) < 0.05
    frame[hot] = rng.integers(0, top, int(hot.sum()), dtype=np.int64).astype(dtype)
    frame[0, 0] = frame[-1, -1] = top
    return frame


def _planes(frame):
    chunk = compression.bshuf_lz4_compress(frame, frame.dtype.itemsize)
    planes, tail, _block_elem, _n_shuf = compression.bshuf_lz4_planes(
        chunk, frame.size, frame.dtype.itemsize
    )
    assert tail == b""
    return planes


def _chunk(frame, block_elem):
    """Filter-32008 chunk with a non-default block size in its header
    (literal-only LZ4 blocks through the codec's NumPy encoder)."""
    flat = frame.reshape(-1).view(np.uint8)
    s = frame.dtype.itemsize
    n = frame.size
    parts = [struct.pack(">Q", n * s), struct.pack(">I", block_elem * s)]
    for lo in range(0, n - n % 8, block_elem):
        hi = min(lo + block_elem, n - n % 8)
        shuf = compression.bitshuffle_encode_np(flat[lo * s : hi * s], s)
        comp = compression._lz4_compress_block_np(bytes(shuf))
        parts += [struct.pack(">I", len(comp)), comp]
    return b"".join(parts)


@pytest.mark.parametrize("elem_size", [1, 2, 4])
def test_untranspose_plain_matches_jax(elem_size):
    """Bit-equal to every JAX formulation of the bit map: the butterfly, the
    8-pass reference, the SWAR form and the u32-word wide form."""
    rng = np.random.default_rng(elem_size)
    planes = rng.integers(0, 256, size=(5, 8 * elem_size * 24), dtype=np.uint8)
    got = tbd.untranspose_planes_plain(torch.from_numpy(planes), elem_size)
    assert got.dtype == tbd._UNSIGNED[elem_size]
    for jax_fn in (jbd.untranspose_planes, jbd.untranspose_planes_ref, jbd.untranspose_planes_swar):
        want = np.asarray(jax_fn(jnp.asarray(planes), elem_size))
        np.testing.assert_array_equal(got.numpy(), want)
    # the u32-word form: planes viewed as little-endian words, one u32 an element
    wide = np.asarray(jbd.untranspose_planes_to_wide(jnp.asarray(planes.view(np.uint32)), elem_size))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), wide)
    # the kernel's wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(tbd.untranspose_planes(torch.from_numpy(planes), elem_size).numpy(),
                                  got.numpy())
    with pytest.raises(ValueError, match="8-element groups"):
        tbd.untranspose_planes_plain(torch.from_numpy(planes[:, :-1]), elem_size)


@pytest.mark.parametrize("h,w", [(16, 256), (36, 132), (40, 1030), (20, 4148)])
def test_frames_from_planes_matches_jax_assembly(h, w):
    """u16: the port's decode against the JAX ingest composition, the wide
    untranspose then the Pallas frame-assembly kernel."""
    frames = np.stack([_frame(h, w, np.uint16, seed=h + k) for k in range(2)])
    planes = np.stack([_planes(f) for f in frames])  # (2, n_blocks, 8192)
    b, n_blocks, block_bytes = planes.shape
    wide = jbd.untranspose_planes_to_wide(
        jnp.asarray(planes.reshape(b * n_blocks, block_bytes).view(np.uint32)), 2
    )
    want = np.asarray(frames_from_flat_wide(wide.reshape(b, -1), h, w, interpret=True))[..., :w]
    before = tbd.frames_from_planes.launches
    got = tbd.frames_from_planes(torch.from_numpy(planes), h, w, torch.uint16)
    assert tbd.frames_from_planes.launches == before  # the plain version ran
    assert got.dtype == torch.uint16 and tuple(got.shape) == (b, h, w)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), frames)
    assert (h * w) % 4096 == 0 or n_blocks * 4096 > h * w  # partial final block


@pytest.mark.parametrize("h,w", [(24, 300), (20, 4148)])
def test_frames_from_planes_u32(h, w):
    frames = np.stack([_frame(h, w, np.uint32, seed=3 + k) for k in range(3)])
    frames[1, 5, :7] = 0xFFFFFFFF
    planes = np.stack([_planes(f) for f in frames])  # 2048-element blocks
    b, n_blocks, block_bytes = planes.shape
    assert block_bytes == 8192
    want = np.asarray(
        jbd.untranspose_planes(jnp.asarray(planes.reshape(b * n_blocks, block_bytes)), 4, jnp.uint32)
    ).reshape(b, -1)[:, : h * w]
    got = tbd.frames_from_planes(torch.from_numpy(planes), h, w, torch.uint32)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy().reshape(b, -1), want)
    np.testing.assert_array_equal(got.numpy(), frames)


@pytest.mark.parametrize("block_elem", [200, 1024])
@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_non_default_block_size_from_chunk_header(block_elem, dtype):
    h, w = 30, 100
    frame = _frame(h, w, dtype, seed=block_elem)
    chunk = _chunk(frame, block_elem)
    s = frame.dtype.itemsize
    np.testing.assert_array_equal(
        compression.bshuf_lz4_decompress(chunk, frame.size, s).view(dtype), frame.reshape(-1)
    )
    planes, _, got_block, _ = compression.bshuf_lz4_planes(chunk, frame.size, s)
    assert got_block == block_elem and planes.shape[1] == block_elem * s
    want = np.asarray(jbd.untranspose_planes(jnp.asarray(planes), s)).reshape(-1)[: h * w]
    tdt = torch.uint16 if dtype == np.uint16 else torch.uint32
    got = tbd.frames_from_planes(torch.from_numpy(planes[None]), h, w, tdt)
    np.testing.assert_array_equal(got.numpy().reshape(-1), want)
    np.testing.assert_array_equal(got.numpy()[0], frame)


def test_guards():
    planes = torch.zeros((1, 2, 8192), dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple-of-8 pixel count"):
        tbd.frames_from_planes(planes, 3, 5, torch.uint16)
    with pytest.raises(ValueError, match="planes hold 8192 elements < frame size 8200"):
        tbd.frames_from_planes(planes, 8, 1025, torch.uint16)
    with pytest.raises(TypeError):
        tbd.frames_from_planes(planes, 8, 16, torch.int32)
    with pytest.raises(TypeError):
        tbd.frames_from_planes(planes.to(torch.int32), 8, 16, torch.uint16)


def test_planes_to_frame_host_matches_jax():
    for dtype, (h, w) in ((np.uint16, (36, 132)), (np.uint32, (20, 130))):
        frame = _frame(h, w, dtype, seed=9)
        planes = _planes(frame)
        got = tbd.planes_to_frame_host(planes, h * w, frame.dtype.itemsize)
        want = jbd.planes_to_frame_host(planes, h * w, frame.dtype.itemsize)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got.view(dtype).reshape(h, w), frame)
