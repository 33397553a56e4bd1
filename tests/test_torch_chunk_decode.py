"""The port's whole-chunk decode (ffs_tpu_torch.ops.bitshuffle_device
``decode_blocks`` and ``bshuf_lz4_decompress_device``) against ffs_tpu's
functions of the same names and against the host codec, bit for bit.

The cases are those of tests/test_bitshuffle_device.py: 8-, 16- and 32-bit
elements; a single 8-element group, exactly one block, several blocks, a
zero-padded final partial block, a raw tail of 1-7 elements and a tail
alone.  On the CPU the untranspose is the row-5 kernel's plain version
(the kernel's launch counter stays put); the chunks come from the port's
codec.  Tolerance: none, every byte equal.
"""

import numpy as np
import pytest
import torch

from ffs_tpu.io import compression as jcompression
from ffs_tpu.ops import bitshuffle_device as jbd
from ffs_tpu_torch.io import compression
from ffs_tpu_torch.ops import bitshuffle_device as tbd

CPU = torch.device("cpu")
DTYPES = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _data(n_elem, elem_size, seed):
    """tests/test_bitshuffle_device.py's data: uniform over the type, with
    all-ones, MSB-only and zero planted first."""
    rng = np.random.default_rng(seed)
    dtype = DTYPES[elem_size]
    info = np.iinfo(dtype)
    data = rng.integers(0, int(info.max) + 1, size=n_elem, dtype=dtype)
    if n_elem >= 3:
        data[0] = info.max
        data[1] = dtype(1) << (8 * elem_size - 1)
        data[2] = 0
    return data


@pytest.mark.parametrize("elem_size", [1, 2, 4])
@pytest.mark.parametrize(
    "n_elem",
    [
        8,  # single 8-element group
        4096,  # exactly one block at elem_size 2
        4096 * 3,  # several full blocks
        10000,  # partial final block (multiple of 8)
        10007,  # partial final block + 7-element raw tail
        1025,  # one partial block + 1-element raw tail
        63,  # a group and a 7-element tail
        5,  # the raw tail alone
    ],
)
def test_chunk_decode_matches_jax_and_host(n_elem, elem_size):
    data = _data(n_elem, elem_size, seed=n_elem * 7 + elem_size)
    chunk = compression.bshuf_lz4_compress(data, elem_size)
    host = compression.bshuf_lz4_decompress(chunk, n_elem, elem_size)
    before = tbd.frames_from_planes.launches
    got = tbd.bshuf_lz4_decompress_device(chunk, n_elem, elem_size, device=CPU)
    assert tbd.frames_from_planes.launches == before  # the plain version ran
    assert got.dtype == np.uint8 and got.shape == (n_elem * elem_size,)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got.view(DTYPES[elem_size]), data)
    np.testing.assert_array_equal(got, jbd.bshuf_lz4_decompress_device(chunk, n_elem, elem_size))
    np.testing.assert_array_equal(got, jcompression.bshuf_lz4_decompress(chunk, n_elem, elem_size))

    planes, _tail, _block_elem, n_shuf = compression.bshuf_lz4_planes(chunk, n_elem, elem_size)
    if n_shuf:
        blocks = tbd.decode_blocks(planes, elem_size, device=CPU)
        assert blocks.device == CPU and blocks.dtype == tbd._UNSIGNED[elem_size]
        np.testing.assert_array_equal(blocks.numpy(), np.asarray(jbd.decode_blocks(planes, elem_size)))


def test_chunk_decode_without_header():
    """``skip_header=False``: the payload alone, default block size."""
    data = _data(3000, 2, seed=3)
    chunk = compression.bshuf_lz4_compress(data, 2)
    got = tbd.bshuf_lz4_decompress_device(chunk[12:], 3000, 2, skip_header=False, device=CPU)
    np.testing.assert_array_equal(got, jbd.bshuf_lz4_decompress_device(chunk[12:], 3000, 2,
                                                                       skip_header=False))
    np.testing.assert_array_equal(got.view(np.uint16), data)


def test_decode_blocks_takes_a_tensor_where_it_lies():
    rng = np.random.default_rng(11)
    planes = rng.integers(0, 256, size=(3, 4096 * 2), dtype=np.uint8)
    got = tbd.decode_blocks(torch.from_numpy(planes), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbd.decode_blocks(planes, 2)))
    with pytest.raises(ValueError, match="8-element groups"):
        tbd.decode_blocks(torch.from_numpy(planes[:, :-2]), 2)


@pytest.mark.parametrize("elem_size", [1, 2, 4])
@pytest.mark.parametrize("out_dtype", [np.float32, np.int32, np.uint32, np.int16, np.float16])
def test_decode_blocks_out_dtype_as_jax(elem_size, out_dtype):
    """``out_dtype`` (NumPy or torch dtype) as JAX's ``decode_blocks`` takes
    it: bytes cast by value, 2- and 4-byte elements reinterpreted as a type
    of their width, bit for bit; any other width raises in both."""
    rng = np.random.default_rng(17 + elem_size)
    planes = rng.integers(0, 256, size=(2, 1024 * elem_size), dtype=np.uint8)
    for dt in (out_dtype, torch.from_numpy(np.empty(0, out_dtype)).dtype):
        if elem_size > 1 and np.dtype(out_dtype).itemsize != elem_size:
            with pytest.raises(ValueError):
                jbd.decode_blocks(planes, elem_size, out_dtype)
            with pytest.raises(ValueError):
                tbd.decode_blocks(planes, elem_size, dt, device=CPU)
            continue
        want = np.asarray(jbd.decode_blocks(planes, elem_size, out_dtype))
        got = tbd.decode_blocks(planes, elem_size, dt, device=CPU).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_entry_points_pick_the_card_unless_told(monkeypatch):
    """Without FFS_TORCH_DEVICE=cpu and without a card, a host array has no
    device to go to: the entry points raise, they do not decode on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points take it")
    monkeypatch.delenv("FFS_TORCH_DEVICE", raising=False)
    data = _data(64, 2, seed=1)
    chunk = compression.bshuf_lz4_compress(data, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbd.bshuf_lz4_decompress_device(chunk, 64, 2)
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    np.testing.assert_array_equal(tbd.bshuf_lz4_decompress_device(chunk, 64, 2).view(np.uint16),
                                  data)
