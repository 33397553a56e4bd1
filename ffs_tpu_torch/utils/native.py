"""Loader for the port's host C++ library (``csrc/host/ffs_native.cpp``).

The port's own copy of the host decode, compaction and 2D CC routines,
built with the system ``g++`` on first use into ``ffs_tpu_torch/_build/``
(gitignored) under a name keyed by a hash of the source, so a stale binary
never shadows the source.  Returns None when the library cannot be built
or loaded; callers then take their NumPy implementations
(:mod:`..io.compression`, :mod:`..ops.cc2d_host`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "host" / "ffs_native.cpp"
BUILD_DIR = _PKG / "_build"


def _build(so_path: pathlib.Path) -> bool:
    """Compile to a private name and rename, so that concurrent processes
    never load a half-written library."""
    try:
        so_path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so_path.parent)
        os.close(fd)
    except OSError:
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", str(_SOURCE), "-o", tmp],
            check=True,
            capture_output=True,
            timeout=240,
        )
        os.replace(tmp, so_path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL | None:
    """The loaded host library, built on demand; None if unavailable."""
    if not _SOURCE.exists():
        return None
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
    so_path = BUILD_DIR / f"libffs_native-{digest}.so"
    if not so_path.exists() and not _build(so_path):
        return None
    try:
        native = ctypes.CDLL(str(so_path))
    except OSError:
        return None
    native.ffs_lz4_decompress_block.restype = ctypes.c_longlong
    native.ffs_lz4_compress_block.restype = ctypes.c_longlong
    native.ffs_bshuf_lz4_compress.restype = ctypes.c_longlong
    native.ffs_byte_offset_decompress.restype = ctypes.c_longlong
    native.ffs_bshuf_lz4_decompress.restype = ctypes.c_int
    native.ffs_bshuf_lz4_planes.restype = ctypes.c_int
    native.ffs_bitshuffle_decode.restype = ctypes.c_int
    native.ffs_bitshuffle_encode.restype = ctypes.c_int
    native.ffs_cc2d.restype = ctypes.c_int
    native.ffs_untranspose_kind.argtypes = []
    native.ffs_untranspose_kind.restype = ctypes.c_int
    return native
