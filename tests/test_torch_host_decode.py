"""The port's host bitshuffle decode (``csrc/host/ffs_native.cpp``: the
vector untranspose) against the NumPy oracle and ffs_tpu's native decode,
bit for bit.

``ffs_bitshuffle_decode`` (one block) is held to
``io.compression.bitshuffle_decode_np``; ``bshuf_lz4_decompress`` (a whole
filter-32008 chunk) to the NumPy untranspose of each LZ4 block, to
``ffs_tpu.io.compression.bshuf_lz4_decompress`` (the scalar bit loop) and
to the data the chunk was encoded from.  Block lengths put the vector path's
runs of 16 columns at and around their edges (8 to 136 elements, 4096, the
default); the chunk sizes end in a partial block (128 k + 8) and, for
Jungfrau 1M's 1066 x 1030, in a raw tail of ``n % 8`` elements.
Tolerance: none, every byte equal.
"""

from __future__ import annotations

import ctypes
import json
import platform
import struct

import numpy as np
import pytest

from ffs_tpu.io import compression as jcompression
from ffs_tpu_torch.io import compression, shm
from ffs_tpu_torch.utils.native import lib

DTYPES = {1: np.uint8, 2: np.uint16, 4: np.uint32}
DATA = ["zeros", "ones", "random", "poisson2"]
BLOCKS = [8, 16, 120, 128, 136, 4096, 0]  # elements; 0: the default block
JUNGFRAU = 1066 * 1030  # 1,097,980 pixels: 4 elements past a multiple of 8
EIGER16M = (4362, 4148)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _data(kind: str, n_elem: int, elem_size: int, seed: int) -> np.ndarray:
    dtype = DTYPES[elem_size]
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros(n_elem, dtype)
    if kind == "ones":  # every byte 0xFF
        return np.full(n_elem, np.iinfo(dtype).max, dtype)
    if kind == "random":
        return rng.integers(0, int(np.iinfo(dtype).max) + 1, size=n_elem, dtype=dtype)
    return rng.poisson(2.0, size=n_elem).astype(dtype)


def _encode(data: np.ndarray, elem_size: int, block_elem: int) -> bytes:
    """The filter-32008 chunk of ``data`` in blocks of ``block_elem``
    elements (0: the default, left to the decoder by a zero in the header)."""
    native = lib()
    flat = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    n_elem = flat.size // elem_size
    cap = 2 * flat.size + 4096
    out = np.empty(cap, np.uint8)
    written = native.ffs_bshuf_lz4_compress(
        _ptr(flat), ctypes.c_longlong(n_elem), ctypes.c_longlong(elem_size), _ptr(out),
        ctypes.c_longlong(cap), ctypes.c_longlong(block_elem))
    assert written > 0
    header = struct.pack(">Q", flat.size) + struct.pack(">I", block_elem * elem_size)
    return header + out[:written].tobytes()


def _numpy_decode(chunk: bytes, n_elem: int, elem_size: int) -> np.ndarray:
    """The NumPy oracle: each block's LZ4 (the unchanged block decoder),
    then ``bitshuffle_decode_np``; the raw tail copied."""
    (block_bytes,) = struct.unpack(">I", chunk[8:12])
    block_elem = block_bytes // elem_size or compression._default_block_elems(elem_size)
    payload = np.frombuffer(chunk, np.uint8)[12:]
    out = np.empty(n_elem * elem_size, np.uint8)
    n_shuf = n_elem - n_elem % 8
    done = i = 0
    while done < n_shuf:
        this_elem = min(block_elem, n_shuf - done)
        raw = np.empty(this_elem * elem_size, np.uint8)
        (comp_len,) = struct.unpack(">I", payload[i:i + 4].tobytes())
        n = lib().ffs_lz4_decompress_block(_ptr(payload[i + 4:]), ctypes.c_longlong(comp_len),
                                           _ptr(raw), ctypes.c_longlong(raw.size))
        assert n == raw.size
        out[done * elem_size:(done + this_elem) * elem_size] = compression.bitshuffle_decode_np(
            raw, this_elem, elem_size)
        i += 4 + comp_len
        done += this_elem
    out[n_shuf * elem_size:] = payload[i:i + (n_elem - n_shuf) * elem_size]
    return out


def _check_chunk(chunk: bytes, data: np.ndarray, elem_size: int) -> None:
    n_elem = data.size
    before = compression.vector_decodes()
    got = compression.bshuf_lz4_decompress(chunk, n_elem, elem_size)
    assert compression.vector_decodes() == before + 1
    want = data.view(np.uint8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _numpy_decode(chunk, n_elem, elem_size))
    np.testing.assert_array_equal(got, jcompression.bshuf_lz4_decompress(chunk, n_elem,
                                                                          elem_size))


def test_the_untranspose_is_vectorised_on_x86_64():
    kind = compression.untranspose_kind()
    assert kind in ((1, 2) if platform.machine() in ("x86_64", "AMD64") else (0, 1, 2))


@pytest.mark.parametrize("kind", DATA)
@pytest.mark.parametrize("n_elem", [8, 16, 120, 128, 136, 4096, 4103])
@pytest.mark.parametrize("elem_size", [1, 2, 4, 3, 8])
def test_block_untranspose_matches_numpy(elem_size, n_elem, kind):
    """One block of any bytes (every input is a valid bitshuffled block),
    with a raw tail at 4103 elements; 3- and 8-byte elements take the
    one-word path."""
    rng = np.random.default_rng(n_elem * 10 + elem_size)
    if kind == "random":
        buf = rng.integers(0, 256, size=n_elem * elem_size, dtype=np.uint8)
    elif kind == "poisson2":
        buf = rng.poisson(2.0, size=n_elem * elem_size).astype(np.uint8)
    else:
        buf = np.full(n_elem * elem_size, 0xFF if kind == "ones" else 0, np.uint8)
    out = np.full(n_elem * elem_size, 0x5A, np.uint8)  # no byte left unwritten
    assert lib().ffs_bitshuffle_decode(_ptr(buf), _ptr(out), ctypes.c_longlong(n_elem),
                                       ctypes.c_longlong(elem_size)) == 0
    np.testing.assert_array_equal(out, compression.bitshuffle_decode_np(buf, n_elem, elem_size))


@pytest.mark.parametrize("kind", DATA)
@pytest.mark.parametrize("n_elem", [128 * 37 + 8, 128 * 37 + 13], ids=["partial", "tail"])
@pytest.mark.parametrize("block", BLOCKS, ids=[f"block{b}" if b else "default" for b in BLOCKS])
@pytest.mark.parametrize("elem_size", [1, 2, 4])
def test_chunk_decode_matches_numpy_and_jax(elem_size, block, n_elem, kind):
    data = _data(kind, n_elem, elem_size, seed=block * 31 + n_elem + elem_size)
    _check_chunk(_encode(data, elem_size, block), data, elem_size)


@pytest.mark.parametrize("kind", DATA)
@pytest.mark.parametrize("block", [4096, 0], ids=["block4096", "default"])
@pytest.mark.parametrize("elem_size", [1, 2, 4])
def test_jungfrau_frame_decode_matches_numpy_and_jax(elem_size, block, kind):
    """A Jungfrau 1M frame: a partial final block and a 4-element raw tail."""
    data = _data(kind, JUNGFRAU, elem_size, seed=elem_size + block)
    _check_chunk(_encode(data, elem_size, block), data, elem_size)


def test_eiger16m_frame_through_shmread(tmp_path):
    """One Poisson(2) Eiger 16M u16 frame in a /dev/shm stream layout."""
    h, w = EIGER16M
    frame = np.random.default_rng(16).poisson(2.0, size=(h, w)).astype(np.uint16)
    header = {"nimages": 1, "y_pixels_in_detector": h, "x_pixels_in_detector": w,
              "bit_depth_image": 16, "countrate_correction_count_cutoff": 65530,
              "detector_distance": 250.0, "y_pixel_size": 7.5e-05, "x_pixel_size": 7.5e-05,
              "beam_center_y": h / 2, "beam_center_x": w / 2}
    (tmp_path / "start_1").write_text(json.dumps(header))
    (tmp_path / "start_4").write_text("{}")
    np.zeros(h * w, np.int32).tofile(tmp_path / "start_5")
    chunk = compression.bshuf_lz4_compress(frame, 2)
    (tmp_path / "image_000000_2").write_bytes(chunk)

    before = compression.vector_decodes()
    got = shm.SHMRead(str(tmp_path)).get_image(0)
    assert compression.vector_decodes() == before + 1
    assert got.dtype == np.uint16 and got.shape == (h, w)
    np.testing.assert_array_equal(got, frame)
    np.testing.assert_array_equal(got.view(np.uint8).reshape(-1),
                                  _numpy_decode(chunk, h * w, 2))
    np.testing.assert_array_equal(got.view(np.uint8).reshape(-1),
                                  jcompression.bshuf_lz4_decompress(chunk, h * w, 2))
