"""SSX indexing throughput on the card: indexed images/s of
``SSXIndexer.index_batch``.

    python -m ffs_tpu_torch.tools.bench_ssx

Counterpart of the repo's ``tools/bench_ssx.py`` (``python -m
ffs_tpu_torch.bench`` runs it in-process as its SSX stage): 64 stills of the
adversarial suite's 30 x 40 x 50 A cell (``tools/ssx_adversarial.py``'s
generators, ten noise spots each; ~50-300 spots an image) through the
indexer in batches of 64, rlps, the 32768-direction search on the card,
refinement, assembly, assignment and stills prediction included.  Two warm
batches, then ``REPS`` passes over the stills, each moved by a
sub-millipixel jitter as the JAX tool moves them; one metric line,
``ssx_index_images_per_s``, against the bar of 100 indexed images/s (a ~20%
hit rate of a 500 Hz Eiger collection).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .. import bench
from ..indexing.ssx import SSXIndexer
from . import ssx_adversarial as adv

BAR = 100.0


def stills(n: int):
    """The JAX tool's ``n`` stills (seeds 1..n): (images, panel, wavelength)."""
    images = []
    for seed in range(n):
        crystal, panel, wavelength, s0, rng = adv.make_experiment(seed + 1)
        obs = adv.lattice_spots(crystal, panel, s0, rng)
        images.append(np.concatenate([obs, adv.noise_spots(rng, 10)]))
    return images, panel, wavelength


def run_stage(run: bench.Run) -> None:
    since = run.counts()
    n = run.size("ssx_images")
    reps = run.reps("FFS_BENCH_SSX_REPS")
    batch = run.size("ssx_batch")
    images, panel, wavelength = stills(n)
    indexer = SSXIndexer(device=run.device)
    indexer.panel, indexer.cell, indexer.wavelength = panel, adv.CELL, wavelength

    indexer.index_batch(images[:batch])
    indexer.index_batch([im + 5e-4 for im in images[:batch]])
    t0 = time.perf_counter()
    for rep in range(reps):
        n_ok = 0
        jitter = 1e-3 * (rep + 1)
        for lo in range(0, n, batch):
            for result, _ in indexer.index_batch([im + jitter for im in images[lo : lo + batch]]):
                n_ok += result is not None
    rate = n * reps / (time.perf_counter() - t0)
    spots = [len(x) for x in images]
    run.line({"ssx": {"images": n, "reps": reps, "batch": batch, "spots": [min(spots), max(spots)],
                      "indexed": n_ok}})
    run.profile("ssx_index_images_per_s", lambda: indexer.index_batch(images[:batch]))
    run.emit("ssx_index_images_per_s", rate, "images/s/chip (~50-300 spots, 32768-dir search)",
             BAR, since=since)


def main() -> int:
    run = bench.open_run()
    run.header()
    bench.guarded(run, "ssx", run_stage)
    return run.exit_code()


if __name__ == "__main__":
    sys.exit(main())
