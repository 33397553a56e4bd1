"""Chunk decompression: bitshuffle-LZ4 (HDF5 filter 32008) and CBF byte-offset.

The hot path goes through the native library (csrc/host/ffs_native.cpp, the
equivalent of the reference's bitshuffle-library dependency, reference:
spotfinder/spotfinder.cc:823-855); NumPy fallbacks keep everything working
compiler-free and serve as the oracle for the native round-trip tests.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np

from ..utils.native import lib


_vector = threading.local()  # .n: chunks this thread decoded through a vector untranspose


def untranspose_kind() -> int:
    """The native library's bit untranspose: 0 its one-word path alone,
    1 SSE2; -1 without the library (the NumPy decode)."""
    native = lib()
    return -1 if native is None else int(native.ffs_untranspose_kind())


def vector_decodes() -> int:
    """Bitshuffle-LZ4 chunks that the calling thread has decoded on the host
    through a vector untranspose."""
    return getattr(_vector, "n", 0)


def _default_block_elems(elem_size: int) -> int:
    block = 8192 // elem_size
    block = (block // 8) * 8
    return max(block, 8)


# ---------------------------------------------------------------------------
# NumPy reference implementations
# ---------------------------------------------------------------------------


def lz4_decompress_block_np(src: bytes, dst_size: int) -> bytearray:
    """Pure-Python LZ4 block decoder (slow; oracle for the native one)."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                s = src[i]
                i += 1
                lit += s
                if s != 255:
                    break
        out += src[i : i + lit]
        i += lit
        if i >= n:
            break
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        mlen = token & 0xF
        if mlen == 15:
            while True:
                s = src[i]
                i += 1
                mlen += s
                if s != 255:
                    break
        mlen += 4
        start = len(out) - offset
        for k in range(mlen):
            out.append(out[start + k])
    if len(out) != dst_size:
        raise ValueError(f"LZ4 decode size mismatch: {len(out)} != {dst_size}")
    return out


def bitshuffle_decode_np(buf: np.ndarray, n_elem: int, elem_size: int) -> np.ndarray:
    """Inverse bitshuffle of one block (uint8 in, uint8 out)."""
    buf = np.frombuffer(bytes(buf), dtype=np.uint8)
    n8 = n_elem - (n_elem % 8)
    out = np.empty(n_elem * elem_size, dtype=np.uint8)
    if n8:
        body = buf[: n8 * elem_size].reshape(elem_size, 8, n8 // 8)
        # bit t of row byte m -> element 8m+t; row kk holds element bit kk
        # (LSB plane first: upstream AVX2 writes movemask(MSB) to row 7-kk)
        bits = np.unpackbits(body, axis=2, bitorder="little")  # (S, 8, n8)
        weights = (1 << np.arange(8, dtype=np.uint16)).astype(np.uint16)
        elems = (bits.astype(np.uint16) * weights[None, :, None]).sum(axis=1)
        out[: n8 * elem_size] = elems.astype(np.uint8).T.reshape(-1)
    out[n8 * elem_size :] = buf[n8 * elem_size : n_elem * elem_size]
    return out


def bitshuffle_encode_np(data: np.ndarray, elem_size: int) -> np.ndarray:
    data = np.frombuffer(bytes(data), dtype=np.uint8)
    n_elem = len(data) // elem_size
    n8 = n_elem - (n_elem % 8)
    out = np.empty_like(data)
    if n8:
        elems = data[: n8 * elem_size].reshape(n8, elem_size).T  # (S, n8)
        bits = np.unpackbits(
            elems.reshape(elem_size, n8, 1), axis=2, bitorder="little"
        )  # (S, n8, 8) LSB first -> index kk matches bit plane kk
        rows = np.packbits(
            bits.transpose(0, 2, 1), axis=2, bitorder="little"
        )  # (S, 8, n8//8)
        out[: n8 * elem_size] = rows.reshape(-1)
    out[n8 * elem_size :] = data[n8 * elem_size :]
    return out


def byte_offset_decompress_np(src: bytes, n_out: int) -> np.ndarray:
    out = np.empty(n_out, dtype=np.int32)
    value = 0
    i = 0
    for k in range(n_out):
        d = src[i]
        i += 1
        if d != 0x80:
            value += d - 256 if d >= 128 else d
        else:
            d16 = struct.unpack_from("<h", src, i)[0]
            i += 2
            if d16 != -32768:
                value += d16
            else:
                value += struct.unpack_from("<i", src, i)[0]
                i += 4
        out[k] = value
    return out


# ---------------------------------------------------------------------------
# Public API: native when available, NumPy otherwise
# ---------------------------------------------------------------------------


def bshuf_lz4_decompress(
    chunk: bytes, n_elem: int, elem_size: int, skip_header: bool = True
) -> np.ndarray:
    """Decode a bitshuffle-LZ4 HDF5 chunk into a flat uint8 buffer.

    ``skip_header``: the filter prepends 8B BE total size + 4B BE block size
    (the reference skips 12 bytes: spotfinder.cc:829-833).
    """
    block_elem = 0
    payload = chunk
    if skip_header:
        block_bytes = struct.unpack(">I", chunk[8:12])[0]
        if block_bytes:
            block_elem = block_bytes // elem_size
        payload = chunk[12:]

    out = np.empty(n_elem * elem_size, dtype=np.uint8)
    native = lib()
    if native is not None:
        src = np.frombuffer(payload, dtype=np.uint8)
        rc = native.ffs_bshuf_lz4_decompress(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_longlong(len(src)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_longlong(n_elem),
            ctypes.c_longlong(elem_size),
            ctypes.c_longlong(block_elem),
        )
        if rc != 0:
            raise ValueError(f"native bshuf-lz4 decode failed: {rc}")
        if untranspose_kind() > 0:
            _vector.n = vector_decodes() + 1
        return out

    # NumPy fallback.  Upstream framing (bitshuffle
    # bshuf_blocked_wrap_fun): only the first n_elem - n_elem % 8 elements
    # are bitshuffled into length-prefixed LZ4 blocks; the final
    # n_elem % 8 elements are appended RAW after all blocks.
    if block_elem <= 0:
        block_elem = _default_block_elems(elem_size)
    if block_elem % 8:
        raise ValueError(f"block size {block_elem} elements not a multiple of 8")
    n_shuf = n_elem - (n_elem % 8)
    done = 0
    i = 0
    while done < n_shuf:
        this_elem = min(block_elem, n_shuf - done)
        this_bytes = this_elem * elem_size
        (comp_len,) = struct.unpack_from(">I", payload, i)
        i += 4
        raw = lz4_decompress_block_np(payload[i : i + comp_len], this_bytes)
        i += comp_len
        out[done * elem_size : done * elem_size + this_bytes] = bitshuffle_decode_np(
            np.frombuffer(bytes(raw), np.uint8), this_elem, elem_size
        )
        done += this_elem
    tail_bytes = (n_elem % 8) * elem_size
    if tail_bytes:
        tail = payload[i : i + tail_bytes]
        if len(tail) != tail_bytes:
            raise ValueError("truncated raw tail in bshuf-lz4 chunk")
        out[n_shuf * elem_size :] = np.frombuffer(tail, np.uint8)
    return out


def bshuf_lz4_planes(
    chunk: bytes, n_elem: int, elem_size: int, skip_header: bool = True
) -> tuple[np.ndarray, bytes, int, int]:
    """LZ4-only half of the chunk decode: per-block LZ4 into a stacked
    plane matrix, leaving the bit untranspose to the caller (the device —
    ops/bitshuffle_device.untranspose_planes; reference offload note:
    spotfinder.cc:823-842).

    Returns (planes, tail, block_elem, n_shuf): planes is
    (n_blocks, block_elem * elem_size) uint8 with a zero-padded final
    partial block; tail is the raw (unshuffled) n_elem % 8 trailing
    elements' bytes; n_shuf = n_elem - n_elem % 8.
    """
    block_elem = 0
    payload = chunk
    if skip_header:
        block_bytes = struct.unpack(">I", chunk[8:12])[0]
        if block_bytes:
            block_elem = block_bytes // elem_size
        payload = chunk[12:]
    if block_elem <= 0:
        block_elem = _default_block_elems(elem_size)
    if block_elem % 8:
        raise ValueError(f"block size {block_elem} elements not a multiple of 8")

    n_shuf = n_elem - (n_elem % 8)
    n_blocks = (n_shuf + block_elem - 1) // block_elem
    planes = np.zeros((max(n_blocks, 1), block_elem * elem_size), dtype=np.uint8)
    native = lib()
    if native is not None and hasattr(native, "ffs_bshuf_lz4_planes"):
        src = np.frombuffer(payload, dtype=np.uint8)
        rc = native.ffs_bshuf_lz4_planes(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_longlong(len(src)),
            planes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_longlong(n_elem),
            ctypes.c_longlong(elem_size),
            ctypes.c_longlong(block_elem),
        )
        if rc != 0:
            raise ValueError(f"native bshuf-lz4 planes decode failed: {rc}")
        tail_bytes = (n_elem % 8) * elem_size
        tail = b""
        if tail_bytes:
            tail = bytes(payload[-tail_bytes:])
            if len(tail) != tail_bytes:
                raise ValueError("truncated raw tail in bshuf-lz4 chunk")
        return planes[:n_blocks], tail, block_elem, n_shuf
    done = 0
    i = 0
    b = 0
    while done < n_shuf:
        this_elem = min(block_elem, n_shuf - done)
        this_bytes = this_elem * elem_size
        (comp_len,) = struct.unpack_from(">I", payload, i)
        i += 4
        block = payload[i : i + comp_len]
        i += comp_len
        if native is not None:
            src_arr = np.frombuffer(block, dtype=np.uint8)
            n = native.ffs_lz4_decompress_block(
                src_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_longlong(len(src_arr)),
                planes[b].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_longlong(this_bytes),
            )
            if n != this_bytes:
                raise ValueError(f"lz4 block decode failed: {n}")
        else:
            planes[b, :this_bytes] = np.frombuffer(
                bytes(lz4_decompress_block_np(block, this_bytes)), np.uint8
            )
        if this_elem < block_elem:
            # A partial final block is bit-transposed at its OWN extent:
            # its layout is (S, 8, this_elem/8), so under the fixed
            # (S, 8, block_elem/8) full-block view its rows must be
            # re-spread to the full-block row offsets (elements past
            # this_elem then decode from the zero padding).
            this_bytes = this_elem * elem_size
            packed = planes[b, :this_bytes].copy()
            planes[b] = 0
            planes[b].reshape(elem_size, 8, block_elem // 8)[
                :, :, : this_elem // 8
            ] = packed.reshape(elem_size, 8, this_elem // 8)
        done += this_elem
        b += 1

    tail_bytes = (n_elem % 8) * elem_size
    tail = b""
    if tail_bytes:
        tail = bytes(payload[i : i + tail_bytes])
        if len(tail) != tail_bytes:
            raise ValueError("truncated raw tail in bshuf-lz4 chunk")
    return planes[:n_blocks], tail, block_elem, n_shuf


def bshuf_lz4_compress(
    data: np.ndarray, elem_size: int, with_header: bool = True
) -> bytes:
    """Encode with the filter-32008 framing (test fixture / SHM writer)."""
    flat = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    n_elem = len(flat) // elem_size
    block_elem = _default_block_elems(elem_size)

    native = lib()
    if native is not None:
        cap = len(flat) * 2 + 4096
        out = np.empty(cap, dtype=np.uint8)
        written = native.ffs_bshuf_lz4_compress(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_longlong(n_elem),
            ctypes.c_longlong(elem_size),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_longlong(cap),
            ctypes.c_longlong(block_elem),
        )
        if written < 0:
            raise ValueError(f"native bshuf-lz4 encode failed: {written}")
        payload = bytes(out[:written])
    else:
        parts = []
        n_shuf = n_elem - (n_elem % 8)  # raw tail per upstream framing
        done = 0
        while done < n_shuf:
            this_elem = min(block_elem, n_shuf - done)
            block = flat[done * elem_size : (done + this_elem) * elem_size]
            shuf = bitshuffle_encode_np(block, elem_size)
            comp = _lz4_compress_block_np(bytes(shuf))
            parts.append(struct.pack(">I", len(comp)) + comp)
            done += this_elem
        if n_elem % 8:
            parts.append(bytes(flat[n_shuf * elem_size :]))
        payload = b"".join(parts)

    if with_header:
        header = struct.pack(">Q", n_elem * elem_size) + struct.pack(
            ">I", block_elem * elem_size
        )
        return header + payload
    return payload


def _lz4_compress_block_np(data: bytes) -> bytes:
    """Literal-only LZ4 block (valid, not compact) for the no-native path."""
    out = bytearray()
    i, n = 0, len(data)
    # emit as one literal run (token 15 + extension bytes)
    lit = n
    out.append(0xF0 if lit >= 15 else lit << 4)
    if lit >= 15:
        rest = lit - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    out += data
    return bytes(out)


def lz4_chunk_decompress(chunk: bytes, n_bytes: int) -> np.ndarray:
    """Decode an HDF5 filter-32004 (plain LZ4) chunk: 8B BE total size +
    4B BE block size, then per block a BE u32 length + LZ4 block data."""
    block_bytes = struct.unpack(">I", chunk[8:12])[0] or n_bytes
    payload = chunk[12:]
    out = np.empty(n_bytes, dtype=np.uint8)
    native = lib()
    done = 0
    i = 0
    while done < n_bytes:
        this_bytes = min(block_bytes, n_bytes - done)
        (comp_len,) = struct.unpack_from(">I", payload, i)
        i += 4
        block = payload[i : i + comp_len]
        i += comp_len
        if native is not None:
            src_arr = np.frombuffer(block, dtype=np.uint8)
            n = native.ffs_lz4_decompress_block(
                src_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_longlong(len(src_arr)),
                out[done:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_longlong(this_bytes),
            )
            if n != this_bytes:
                raise ValueError(f"lz4 chunk decode failed: {n}")
        else:
            out[done : done + this_bytes] = np.frombuffer(
                bytes(lz4_decompress_block_np(block, this_bytes)), np.uint8
            )
        done += this_bytes
    return out


def byte_offset_decompress(src: bytes, n_out: int) -> np.ndarray:
    """CBF byte-offset decode -> int32 (reference: spotfinder/cbfread.hpp)."""
    native = lib()
    if native is None:
        return byte_offset_decompress_np(src, n_out)
    out = np.empty(n_out, dtype=np.int32)
    buf = np.frombuffer(src, dtype=np.uint8)
    n = native.ffs_byte_offset_decompress(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_longlong(len(buf)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_longlong(n_out),
    )
    if n != n_out:
        raise ValueError(f"byte-offset decode produced {n} of {n_out} values")
    return out
