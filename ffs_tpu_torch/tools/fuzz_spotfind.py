"""Differential fuzz of the spotfinding pipeline: the kernel path against the
dense path, on random frames.

    python -m ffs_tpu_torch.tools.fuzz_spotfind [--edges] [N_SEEDS [START_SEED]]

Counterpart of the repo's ``tools/fuzz_spotfind.py`` (defaults 50 seeds from
0).  Each seed draws 2-4 frames of the JAX tool's adversarial content, in
its draw order (Poisson background at a random rate, planted compact spots,
a constant plateau where every window sum ties, a checkerboard patch,
saturated pixels at and above ``trusted_max``, u32 values of 3e9 that the
trusted gate must keep out), so that seed *s* makes the same frames in both
tools.  The seed picks a configuration from a fixed pool (shape, dtype,
algorithm, CC backend, minimum spot size, mask), and processors are cached
per configuration.  Two :class:`~ffs_tpu_torch.spotfind.SpotfindProcessor`
run every frame:

* the kernel path, ``SpotfindConfig(precision="f32", use_kernel=True)``:
  on the card the CUDA threshold walkers (``csrc/dispersion_packed.cu``,
  ``csrc/dispersion_extended_packed.cu``) and, for the planes, the decode
  kernel (``csrc/bitshuffle_frames.cu``); on the CPU their plain versions;
* the dense path, ``use_kernel=False``: the plain ``ops/dispersion.py`` in
  float32.

It demands, frame by frame, equal counts, pixel lists (``linear_index``,
``intensity``) and centroid sets (within 1e-5) for: the kernel path against
the dense path; the batch (``dispatch_batch``) against the per-frame kernel
path; bitshuffle planes decoded on the device (``dispatch_batch_planes``)
against the frames.

``--edges`` draws from :data:`EDGE_CONFIGS` instead, a pool of this port
only, aimed at the walkers' tiling (``ops.dispersion_packed.walker_tiling``:
strips of at most 30 words, segments of rows): widths whose last word holds
one column and whose words split into unequal strips, widths that are not a
multiple of 32, heights that no segment height divides, frames short enough
to be one segment; spots are planted on the strip joins and the last
column.

Runs on the CUDA device, or the CPU under ``FFS_TORCH_DEVICE=cpu``.  A
crash counts as a failure; exits 1 if any seed fails.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

# The JAX tool's pool, verbatim (seed % len picks one); the content of the
# frames is what varies by seed.  Each entry: (h, w, dtype, algorithm,
# cc_backend, min_spot_size, mask_kind, full_trusted_range)
CONFIGS = [
    (96, 128, np.uint16, "dispersion", "device", 1, 0, True),
    (96, 128, np.uint16, "dispersion", "host", 1, 1, True),
    (96, 128, np.uint16, "dispersion", "device", 3, 2, False),
    (96, 128, np.uint32, "dispersion", "host", 1, 2, True),
    (128, 256, np.uint16, "dispersion_extended", "device", 1, 1, True),
    (128, 256, np.uint16, "dispersion_extended", "host", 3, 0, True),
    (128, 256, np.uint32, "dispersion_extended", "device", 1, 2, False),
    (72, 384, np.uint16, "dispersion", "device", 1, 2, True),
    (72, 384, np.uint32, "dispersion", "host", 3, 1, False),
    (72, 384, np.uint16, "dispersion_extended", "device", 1, 0, True),
]

# The walkers' tiling edges (the strip limit is 30 words, the warm-up 2 x 3
# rows for dispersion and 2 x 10 for extended; a segment is at least that
# tall unless it is the whole frame):
# * 961 = 30 x 32 + 1 columns: 31 words in two strips of 16 and 15, the
#   last word holding one column; 1921 = 60 x 32 + 1: 61 words in strips of
#   21, 21 and 19;
# * 200 and 161 columns: not a multiple of 32;
# * 97, 104 and 112 rows: no segment height of the walkers divides them, so
#   the last segment is shorter than the rest;
# * 10 rows (dispersion) and 32 rows (extended): one segment.
# Every frame holds a multiple of 8 pixels, so the planes form runs too.
EDGE_CONFIGS = [
    (40, 961, np.uint16, "dispersion", "host", 1, 0, True),
    (97, 200, np.uint32, "dispersion", "device", 1, 2, False),
    (10, 300, np.uint16, "dispersion", "device", 1, 1, True),
    (32, 961, np.uint32, "dispersion_extended", "host", 1, 0, True),
    (104, 1921, np.uint16, "dispersion_extended", "device", 3, 2, True),
    (112, 161, np.uint16, "dispersion_extended", "host", 1, 1, False),
]
CENTROID_TOL = 1e-5
MAX_STRIP_WORDS = 30  # csrc/common.cuh kMaxStripWords


def _config_mask(kind, h, w):
    """Deterministic per-config mask (cached processors hold the mask, so
    it is a function of the config, not of the seed)."""
    rng = np.random.default_rng(1000 + kind * 31 + h + w)
    mask = np.ones((h, w), dtype=np.uint8)
    if kind == 1:  # module-gap bands
        r0 = int(rng.integers(0, h - 4))
        mask[r0 : r0 + int(rng.integers(1, 5)), :] = 0
        c0 = int(rng.integers(0, w - 4))
        mask[:, c0 : c0 + int(rng.integers(1, 5))] = 0
    elif kind == 2:  # scattered holes
        holes = rng.random((h, w)) < 0.02
        mask[holes] = 0
    return mask


def _random_frame(rng, h, w, dtype, trusted_max):
    lam = float(rng.choice([0.5, 3.0, 8.0]))
    img = rng.poisson(lam, size=(h, w)).astype(np.int64)
    # planted compact spots
    for _ in range(int(rng.integers(1, 12))):
        cy, cx = int(rng.integers(2, h - 2)), int(rng.integers(2, w - 2))
        amp = int(rng.integers(50, 900))
        sz = int(rng.integers(1, 4))
        img[cy - sz // 2 : cy + sz // 2 + 1, cx - sz // 2 : cx + sz // 2 + 1] += amp
    # constant plateau: every window sum ties inside it
    if rng.random() < 0.5:
        r0, c0 = int(rng.integers(0, h - 16)), int(rng.integers(0, w - 16))
        img[r0 : r0 + 16, c0 : c0 + 16] = int(rng.integers(1, 30))
    # checkerboard patch (high local variance)
    if rng.random() < 0.3:
        r0, c0 = int(rng.integers(0, h - 12)), int(rng.integers(0, w - 12))
        yy, xx = np.mgrid[0:12, 0:12]
        img[r0 : r0 + 12, c0 : c0 + 12] = ((yy + xx) % 2) * int(rng.integers(10, 200))
    # saturation: values at and above trusted_max must be excluded
    n_sat = int(rng.integers(0, 20))
    if n_sat:
        ys = rng.integers(0, h, n_sat)
        xs = rng.integers(0, w, n_sat)
        over = np.iinfo(dtype).max if rng.random() < 0.5 else int(trusted_max)
        img[ys, xs] = over
    if dtype == np.uint32 and rng.random() < 0.5:
        # huge u32 values (negative as i32) must stay out by the trusted gate
        ys = rng.integers(0, h, 5)
        xs = rng.integers(0, w, 5)
        img[ys, xs] = 3_000_000_000
    return np.clip(img, 0, np.iinfo(dtype).max).astype(dtype)


def _edge_frame(rng, h, w, dtype, trusted_max):
    """An edge frame: the JAX tool's content drawn at least 32 rows tall
    (its plateau needs 17) and cut to ``h`` rows, then 3x3 spots on the
    strip joins and the last column at random rows."""
    from ..ops.dispersion_packed import strip_words

    img = _random_frame(rng, max(h, 32), w, dtype, trusted_max)[:h].astype(np.int64)
    wps, strips = strip_words(w, MAX_STRIP_WORDS)
    cols = [32 * wps * s + d for s in range(1, strips) for d in (-1, 0)] + [w - 1]
    for cx in cols:
        cy = int(rng.integers(0, h))
        img[max(cy - 1, 0) : cy + 2, max(cx - 1, 0) : cx + 2] += int(rng.integers(50, 900))
    return np.clip(img, 0, np.iinfo(dtype).max).astype(dtype)


def _table_key(res):
    if not len(res.centers_of_mass):
        return None
    return res.centers_of_mass[np.lexsort(res.centers_of_mass.T)]


def _compare(seed, tag, got, want) -> bool:
    """The JAX tool's check of two FrameResults: the four counts, the pixel
    lists exactly, the centroid sets within CENTROID_TOL.  Prints a
    MISMATCH line and returns False where they differ."""
    errs = []
    for f in ("n_strong_pixels", "n_spots", "n_spots_prefilter", "n_strong_pixels_filtered"):
        g, w_ = getattr(got, f), getattr(want, f)
        if g != w_:
            errs.append(f"{f}: {g} != {w_}")
    if not errs:
        if not np.array_equal(got.pixels.linear_index, want.pixels.linear_index):
            errs.append("pixel linear_index mismatch")
        if not np.array_equal(got.pixels.intensity, want.pixels.intensity):
            errs.append("pixel intensity mismatch")
        gk, wk = _table_key(got), _table_key(want)
        if (gk is None) != (wk is None) or (gk is not None and gk.shape != wk.shape):
            errs.append("centroid set mismatch (count)")
        elif gk is not None and not np.allclose(gk, wk, rtol=0, atol=CENTROID_TOL):
            errs.append(f"centroid set mismatch (max diff {np.abs(gk - wk).max():.3e})")
    if errs:
        print(f"MISMATCH seed={seed} [{tag}]: " + "; ".join(errs), flush=True)
    return not errs


class Fuzzer:
    """Processors cached per configuration on one device."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._procs: dict = {}

    def processor(self, h, w, mask, trusted_max, algorithm, cc_backend, use_kernel,
                  min_spot_size):
        from ..spotfind import SpotfindConfig, SpotfindProcessor

        key = (h, w, mask.tobytes(), trusted_max, algorithm, cc_backend, use_kernel,
               min_spot_size)
        if key not in self._procs:
            cfg = SpotfindConfig(
                precision="f32",
                use_kernel=use_kernel,
                algorithm=algorithm,
                cc_backend=cc_backend,
                max_strong_pixels=8192,
                max_spots=4096,
                min_spot_size=min_spot_size,
            )
            self._procs[key] = SpotfindProcessor(w, h, mask, trusted_max, cfg,
                                                 device=self.device)
        return self._procs[key]


def draw(seed: int, edges: bool = False):
    """The seed's configuration, mask, trusted_max and (n, h, w) frames."""
    rng = np.random.default_rng(seed)
    pool = EDGE_CONFIGS if edges else CONFIGS
    cfg = pool[seed % len(pool)]
    h, w, dtype, _, _, _, mask_kind, full_range = cfg
    mask = _config_mask(mask_kind, h, w)
    info = np.iinfo(dtype)
    trusted_max = float(info.max) if full_range else float(info.max // 2)
    nimg = int(rng.integers(2, 5))
    frame = _edge_frame if edges else _random_frame
    stack = np.stack([frame(rng, h, w, dtype, trusted_max) for _ in range(nimg)])
    return cfg, mask, trusted_max, stack


def planes_of(stack: np.ndarray) -> np.ndarray:
    """(n, n_blocks, block bytes) LZ4-decoded bitshuffle planes of each
    frame, through the port's own codec."""
    from ..io import compression

    return np.stack([
        compression.bshuf_lz4_planes(
            compression.bshuf_lz4_compress(fr, fr.dtype.itemsize), fr.size, fr.dtype.itemsize
        )[0]
        for fr in stack
    ])


def run_seed(seed: int, device: torch.device, edges: bool = False,
             fuzzer: Fuzzer | None = None) -> bool:
    """One seed: kernel path against dense per frame, batch against
    per-frame, planes against frames.  True where everything agrees."""
    fuzzer = fuzzer or Fuzzer(device)
    (h, w, dtype, algorithm, cc_backend, min_spot_size, mask_kind,
     _), mask, trusted_max, stack = draw(seed, edges)
    nimg = len(stack)
    common = (h, w, mask, trusted_max, algorithm, cc_backend)
    kernel = fuzzer.processor(*common, True, min_spot_size)
    dense = fuzzer.processor(*common, False, min_spot_size)

    tag = (f"{'edge ' if edges else ''}{h}x{w} {np.dtype(dtype).name} {algorithm} "
           f"cc={cc_backend} mss={min_spot_size} mask={mask_kind} tm={trusted_max:.0f}")
    ok = True
    want = []
    for n in range(nimg):
        w_res = dense.process_frame(n, stack[n], want_com=True)
        g_res = kernel.process_frame(n, stack[n], want_com=True)
        want.append(g_res)
        ok &= _compare(seed, f"{tag} frame {n} packed-vs-dense", g_res, w_res)
    # the batch must equal the per-frame kernel path
    got = kernel.collect_batch(list(range(nimg)), kernel.dispatch_batch(stack), images=stack,
                               want_com=True)
    for n in range(nimg):
        ok &= _compare(seed, f"{tag} frame {n} batch-vs-frame", got[n], want[n])
    # planes decoded on the device must give the frames' results (the
    # planes form needs a multiple of 8 pixels a frame)
    if (h * w) % 8 == 0:
        got_p = kernel.collect_batch(
            list(range(nimg)), kernel.dispatch_batch_planes(planes_of(stack), dtype=dtype),
            images=stack, want_com=True,
        )
        for n in range(nimg):
            ok &= _compare(seed, f"{tag} frame {n} planes-vs-frame", got_p[n], want[n])
    return bool(ok)


def run_seeds(seeds, device: torch.device, edges: bool = False) -> int:
    """Runs ``seeds``; returns the number that failed (a crash is a failure)."""
    fuzzer = Fuzzer(device)
    failures = 0
    for k, seed in enumerate(seeds, 1):
        try:
            failures += not run_seed(seed, device, edges, fuzzer)
        except Exception as e:  # a crash is a finding too
            print(f"CRASH seed={seed}: {type(e).__name__}: {e}", flush=True)
            failures += 1
        if k % 10 == 0:
            print(f"... {k}/{len(seeds)} seeds, {failures} failures", flush=True)
    return failures


def edge_tilings(device: torch.device) -> list[str]:
    """The walker tiling each edge configuration launches with on the CUDA
    ``device``, one frame at a time (the per-frame path)."""
    from ..constants import KERNEL_RADIUS
    from ..ops.dispersion_extended_packed import HALO
    from ..ops.dispersion_packed import launch_tiling

    lines = []
    for h, w, dtype, algorithm, *_ in EDGE_CONFIGS:
        tdtype = torch.uint16 if dtype == np.uint16 else torch.uint32
        frames = torch.zeros((1, h, w), dtype=tdtype, device=device)
        extended = algorithm != "dispersion"
        t = launch_tiling(frames, HALO if extended else KERNEL_RADIUS, extended, not extended)
        last_words = -(-w // 32) - (t.strips - 1) * t.wps
        last_rows = h - (t.segs - 1) * t.seg_rows
        lines.append(f"{h}x{w} {algorithm}: {t.strips} strip(s) of {t.wps} words (last "
                     f"{last_words}), {t.segs} segment(s) of {t.seg_rows} rows (last {last_rows})")
    return lines


def main(argv=None) -> int:
    from ..utils import torchinit

    argv = sys.argv[1:] if argv is None else argv
    edges = "--edges" in argv
    digits = [int(a) for a in argv if a.isdigit()]
    n_seeds = digits[0] if digits else 50
    start = digits[1] if len(digits) > 1 else 0
    torchinit.setup()
    device = torchinit.select_device()
    if edges and device.type == "cuda":
        for line in edge_tilings(device):
            print(f"walker tiling {line}", flush=True)
    t0 = time.time()
    failures = run_seeds(range(start, start + n_seeds), device, edges)
    pool = "edge pool" if edges else "JAX pool"
    print(f"fuzz done: {n_seeds} seeds from {start} ({pool}), {failures} failures, "
          f"{time.time() - t0:.1f} s on {torchinit.device_name(device)}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
