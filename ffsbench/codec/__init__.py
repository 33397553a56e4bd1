"""The benchmark's bitshuffle-LZ4 encoder (``bslz4.cpp``), built with g++.

The library is built on first use into ``ffsbench/_build/`` (a fixed
directory inside the checkout, so that only a checkout's first run builds it)
under a name keyed by a hash of the source, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "bslz4.cpp"
BUILD_DIR = SOURCE.parents[1] / "_build"


def block_elems(elem_size: int) -> int:
    """Bitshuffle's default block: 8192 bytes, a multiple of 8 elements."""
    return max(8, (8192 // elem_size) // 8 * 8)


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The loaded encoder, built first where this source has no library yet."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    so_path = BUILD_DIR / f"libffsbench_bslz4-{digest}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17", str(SOURCE),
                            "-o", tmp], check=True, capture_output=True, timeout=240)
            os.replace(tmp, so_path)  # concurrent builders never load a half-written file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    native = ctypes.CDLL(str(so_path))
    native.ffsbench_bshuf_lz4_encode.restype = ctypes.c_longlong
    native.ffsbench_bshuf_lz4_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong,
    ]
    return native


def encode(frame: np.ndarray) -> bytes:
    """One frame -> its bitshuffle-LZ4 chunk with the 12-byte header."""
    flat = np.ascontiguousarray(frame).reshape(-1)
    elem = flat.dtype.itemsize
    cap = flat.nbytes * 2 + 4096
    out = np.empty(cap, dtype=np.uint8)
    n = lib().ffsbench_bshuf_lz4_encode(flat.ctypes.data, flat.size, elem, out.ctypes.data,
                                        cap, block_elems(elem))
    if n < 0:
        raise RuntimeError(f"bitshuffle-LZ4 encode failed: {n}")
    return out[:n].tobytes()


def encode_all(frames, threads: int) -> list[bytes]:
    """Frames -> chunks, on ``threads`` threads (ctypes releases the GIL)."""
    with ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
        return list(pool.map(encode, frames))
