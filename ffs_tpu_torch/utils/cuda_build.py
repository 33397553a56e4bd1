"""Build and load the package's hand-written CUDA kernels (ffs_tpu_torch/csrc).

Counterpart of :mod:`.native` for the GPU kernels: every ``.cu`` source
under ``csrc/`` is compiled by its own ``nvcc``, all started together, and
the objects are linked into one shared library with a plain C interface, on
first use, and loaded with ``ctypes``.  The library lands in ``ffs_tpu_torch/_build/`` under a name
keyed by a hash of the sources and the flags, so a stale binary can never
shadow the sources after an edit or a checkout.

The flags are part of the kernels' bit-parity contract with the plain
PyTorch versions: ``--fmad=false`` keeps nvcc from contracting a multiply
and an add into one FMA, and ``-prec-div``/``-prec-sqrt`` keep division and
square root correctly rounded.  Never add ``--use_fast_math``.

Unlike the host library there is no fallback: a CUDA tensor either runs
its kernel or raises, so a failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-prec-div=true",
    "-prec-sqrt=true",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills: the build log
)


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    """nvcc from CUDA_HOME, the standard toolkit location, or PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built"
        )
    return found


def _so_path() -> pathlib.Path:
    return BUILD_DIR / f"libffs_kernels-{_digest()}.so"


def build_log() -> str:
    """nvcc's output of the library's build (ptxas's resource lines)."""
    return _so_path().with_suffix(".log").read_text()


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists; return
    its path.  Raises RuntimeError with nvcc's output when the build fails;
    on success nvcc's output lands beside the library (:func:`build_log`)."""
    so_path = _so_path()
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objects = []
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            objects.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failures, logs = [], []
        for cmd, proc in procs:
            out, _ = proc.communicate(timeout=900)
            logs.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                failures.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{out}")
        if failures:
            raise RuntimeError("\n".join(failures))
        tmp = os.path.join(work, so_path.name)
        cmd = [nvcc, "-shared", "-o", tmp, *objects]
        link = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {link.returncode}): {' '.join(cmd)}\n"
                f"{link.stdout}\n{link.stderr}"
            )
        # link to a private name and rename: concurrent processes never
        # load a half-written library
        so_path.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp, so_path)
    return so_path


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    kernels = ctypes.CDLL(str(build()))
    p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    kernels.ffs_dispersion_packed.argtypes = [
        p, i, p, p, i, i, i, i, i, i, f, i, f, f, i, p,
    ]
    kernels.ffs_dispersion_packed.restype = i
    kernels.ffs_dispersion_extended_packed.argtypes = [
        p, i, p, p, i, i, i, i, i, i, f, i, f, f, p,
    ]
    kernels.ffs_dispersion_extended_packed.restype = i
    kernels.ffs_dispersion_fused.argtypes = [
        p, i, p, p, p, p, i, i, i, i, i, i, f, i, f, f, i, p,
    ]
    kernels.ffs_dispersion_fused.restype = i
    kernels.ffs_dispersion_extended_fused.argtypes = [
        p, i, p, p, p, p, i, i, i, i, i, i, f, i, f, f, p,
    ]
    kernels.ffs_dispersion_extended_fused.restype = i
    kernels.ffs_f64_threshold_packed.argtypes = [p, p, p, i, i, i, i, i, i, d, i, d, d, p]
    kernels.ffs_f64_threshold_packed.restype = i
    kernels.ffs_walker_max_strip_words.argtypes = []
    kernels.ffs_walker_max_strip_words.restype = i
    kernels.ffs_dispersion_walker_blocks_per_sm.argtypes = [i, i, i]
    kernels.ffs_dispersion_walker_blocks_per_sm.restype = i
    kernels.ffs_extended_walker_blocks_per_sm.argtypes = [i, i]
    kernels.ffs_extended_walker_blocks_per_sm.restype = i
    kernels.ffs_f64_walker_blocks_per_sm.argtypes = [i]
    kernels.ffs_f64_walker_blocks_per_sm.restype = i
    kernels.ffs_window_gather_planes.argtypes = [p, i, i, i, p, p, i, i, p, p]
    kernels.ffs_window_gather_planes.restype = i
    kernels.ffs_window_gather.argtypes = [p, i, i, p, p, i, i, p, p]
    kernels.ffs_window_gather.restype = i
    kernels.ffs_window_gather_planes_packed.argtypes = [p, i, i, i, p, p, i, i, p, p]
    kernels.ffs_window_gather_planes_packed.restype = i
    kernels.ffs_window_gather_planes_pl.argtypes = [p, i, i, i, p, p, i, i, p, p]
    kernels.ffs_window_gather_planes_pl.restype = i
    kernels.ffs_window_gather_probe.argtypes = [p, i, i, i, p, p, i, i, i, i, i, i, i, p, p]
    kernels.ffs_window_gather_probe.restype = i
    kernels.ffs_window_gather_probe_blocks_per_sm.argtypes = [i, i]
    kernels.ffs_window_gather_probe_blocks_per_sm.restype = i
    kernels.ffs_bitshuffle_frames.argtypes = [p, i, i, i, i, i, p, p]
    kernels.ffs_bitshuffle_frames.restype = i
    kernels.ffs_cuda_error_string.argtypes = [i]
    kernels.ffs_cuda_error_string.restype = ctypes.c_char_p
    return kernels


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib().ffs_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
