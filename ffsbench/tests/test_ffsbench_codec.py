"""The benchmark's encoder against an independent NumPy decoder of the
bitshuffle-LZ4 framing (LZ4 block format, bitshuffle bit planes)."""

from __future__ import annotations

import struct

import numpy as np
import pytest

from ffsbench import codec


def lz4_block_decode(src: bytes, size: int) -> bytes:
    """The LZ4 block format, token by token."""
    out = bytearray()
    i = 0
    while i < len(src):
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += src[i : i + lit]
        i += lit
        if i >= len(src):
            break
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        ml = token & 15
        if ml == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        start = len(out) - offset
        for k in range(ml):  # overlapping copies repeat bytes
            out.append(out[start + k])
    assert len(out) == size
    return bytes(out)


def unshuffle(block: bytes, n: int, elem: int) -> np.ndarray:
    """Bit plane r of byte j of elements 8m..8m+7 -> the elements' bytes."""
    rows = np.frombuffer(block, np.uint8).reshape(elem, 8, n // 8)
    bits = np.unpackbits(rows, axis=2, bitorder="little")  # (elem, 8 planes, n)
    value = (bits.astype(np.uint8) << np.arange(8, dtype=np.uint8)[None, :, None]).sum(
        axis=1, dtype=np.uint8)  # (elem, n): byte j of every element
    return value.T.reshape(-1)


def decode(chunk: bytes, dtype) -> np.ndarray:
    n_bytes, block_bytes = struct.unpack(">QI", chunk[:12])
    elem = np.dtype(dtype).itemsize
    n_elem = n_bytes // elem
    block_elem = block_bytes // elem
    n_shuf = n_elem - n_elem % 8
    out, i, done = bytearray(), 12, 0
    while done < n_shuf:
        this = min(block_elem, n_shuf - done)
        (clen,) = struct.unpack(">I", chunk[i : i + 4])
        raw = lz4_block_decode(chunk[i + 4 : i + 4 + clen], this * elem)
        out += unshuffle(raw, this, elem).tobytes()
        i += 4 + clen
        done += this
    out += chunk[i:]
    return np.frombuffer(bytes(out), dtype).copy()


@pytest.mark.parametrize("shape,dtype", [((64, 80), np.uint16), ((53, 31), np.uint16),
                                         ((40, 130), np.uint32), ((7, 9), np.uint16)])
@pytest.mark.parametrize("kind", ["poisson", "zeros", "full_range"])
def test_encoder_round_trips_through_a_numpy_decoder(shape, dtype, kind):
    rng = np.random.default_rng(11)
    if kind == "poisson":
        frame = rng.poisson(2.0, size=shape).astype(dtype)
        frame[3, 4] = np.iinfo(dtype).max
    elif kind == "zeros":
        frame = np.zeros(shape, dtype)
    else:
        frame = rng.integers(0, np.iinfo(dtype).max, size=shape, dtype=dtype, endpoint=True)
    chunk = codec.encode(frame)
    n_bytes, block_bytes = struct.unpack(">QI", chunk[:12])
    assert n_bytes == frame.nbytes and block_bytes == 8192
    np.testing.assert_array_equal(decode(chunk, dtype), frame.reshape(-1))


def test_encode_all_keeps_order():
    rng = np.random.default_rng(3)
    frames = rng.poisson(5.0, size=(5, 32, 48)).astype(np.uint16)
    chunks = codec.encode_all(frames, threads=3)
    for f, c in zip(frames, chunks):
        np.testing.assert_array_equal(decode(c, np.uint16), f.reshape(-1))
