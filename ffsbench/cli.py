"""The spotfinder process of a benchmark run.

    python -m ffsbench.cli ARGS...

Runs ``ffs_tpu_torch.pipeline.spotfinder.run(ARGS)``, as the console script
``spotfinder_torch`` does, and then prints one JSON line: the exit code, the
card's peak of allocated memory, the modules of the JAX package or JAX that
the process loaded (none may be), and when (wall clock) its Python started
and its imports were done.  Where h5py is not installed, the
table that ``--save-h5`` writes goes to ``results_ffs.h5.npz`` instead (its
columns; ``ReflectionTable.write`` needs h5py).

``FFSBENCH_FAULT`` breaks the timed path for the harness's own tests:
``answer`` alters one frame's strong-pixel count where it is produced,
``stale`` hands each frame the previous frame's result, ``half_batch`` zeroes
the second half of each frame (or of each batch) before it is dispatched.
"""

from __future__ import annotations

import json
import sys
import time

STARTED = time.time()

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ffs_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _plant_fault(kind: str) -> None:
    from ffs_tpu_torch import spotfind

    proc = spotfind.SpotfindProcessor
    if kind == "answer":
        collect, collect_batch = proc.collect, proc.collect_batch

        def alter(res):
            if res.image_number == 3:
                res.n_strong_pixels += 1
            return res

        proc.collect = lambda self, n, r, want_com=False: alter(collect(self, n, r, want_com))
        proc.collect_batch = lambda self, *a, **k: [alter(r) for r in collect_batch(self, *a, **k)]
    elif kind == "stale":
        collect, collect_batch = proc.collect, proc.collect_batch
        last = []

        def stale(res):
            prev = last[0] if last else res
            last[:] = [res]
            prev_copy = type(res)(**{**prev.__dict__, "image_number": res.image_number})
            return prev_copy

        proc.collect = lambda self, n, r, want_com=False: stale(collect(self, n, r, want_com))
        proc.collect_batch = lambda self, *a, **k: [stale(r) for r in collect_batch(self, *a, **k)]
    elif kind == "half_batch":
        dispatch, dispatch_batch = proc.dispatch, proc.dispatch_batch

        def halve(images, axis):
            images = np.array(images)
            n = images.shape[axis]
            idx = [slice(None)] * images.ndim
            idx[axis] = slice(n // 2, n)
            images[tuple(idx)] = 0
            return images

        proc.dispatch = lambda self, image: dispatch(self, halve(image, 0))
        proc.dispatch_batch = lambda self, images: dispatch_batch(self, halve(images, 0))
    else:
        raise SystemExit(f"unknown FFSBENCH_FAULT {kind!r}")


def main(argv: list[str]) -> int:
    import os

    import torch

    from ffs_tpu_torch.models.reflection_table import ReflectionTable
    from ffs_tpu_torch.pipeline import spotfinder

    try:
        import h5py  # noqa: F401
    except ImportError:
        def write_npz(self, path, *args, **kwargs):
            np.savez(str(path) + ".npz", **{k: self[k] for k in self.column_names()})

        ReflectionTable.write = write_npz
    if os.environ.get("FFSBENCH_FAULT"):
        _plant_fault(os.environ["FFSBENCH_FAULT"])
    imported = time.time()
    rc = spotfinder.run(argv)
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    print(json.dumps({"ffsbench_cli": {"rc": rc, "memory_peak_bytes": int(peak),
                                       "forbidden_modules": forbidden_modules(),
                                       "started_unix": STARTED, "imported_unix": imported}}),
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
