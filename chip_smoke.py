"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: the spotfinder, the
integrator (with ``--bg-device``), the predictor CLI and the indexers.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and nvcc.  It
needs no network, and neither JAX nor the JAX package (both are blocked from
import).  Phases, each of which fails the run:

1. device — a CUDA device must exist; prints the card's name and power limit;
2. build — compiles every CUDA kernel from ``ffs_tpu_torch/csrc`` with nvcc
   and prints ptxas's registers, shared memory and spills of the two
   dispersion walkers;
3. kernels — each dispersion kernel against its plain PyTorch version on the
   card, bit for bit over the whole packed output, on full Eiger 16M frames
   (sample images 2 and 5, a seeded Poisson frame with spots and module
   gaps, a u32 frame with 0xFFFFFFFF sentinels, a frame whose 5x5 spots
   straddle every strip and segment boundary of both walkers' launches),
   with and without the mask box count;
4. spotfinder main path — the ``spotfinder`` CLI in-process on the six
   sample frames, f32 (kernels) and f64, both algorithms, reading the pipe
   JSON and holding the anchors (image 2: 9506 px / 9506 spots; image 5:
   2388 px / 2311 spots, extended 3 px); the kernels' launch counters must
   rise;
5. golden — the f32 pixel lists and host spot tables of images 2 and 5
   against tests/data/bench_anchor_golden.npz (every column, peak_intensity
   included);
6. times — kernel and plain version per algorithm at Eiger 16M with CUDA
   events: one frame a launch, a B = 8 launch of distinct frames, and the
   Jungfrau 1M B = 112 batch, each beside its byte bound, with the
   torch.profiler device time of the walker and scan launches beside the
   events; the CLI's frames/s, and the processor's steady frames/s and
   per-stage times on frames already in host memory;
7. integrator main path — a seeded synthetic rotation collection at Eiger
   16M (thaumatin cell, 0.1 degree images, 40 of a 3600-image sweep) goes
   through the ``integrator`` CLI's core on the card: prediction, bounding
   boxes, the blocked Kabsch step in 2048-reflection chunks, backgrounds
   and finalisation.  The accumulators must equal a second run with the
   plain gathers and, for the first 256 reflections, the float64 oracle
   (``integration/reference_kabsch``) exactly; the recovered intensities
   must match the injected ones; both gather kernels' launch counters must
   rise;
8. gathers — each gather kernel against its plain version at the main
   path's shapes, bit for bit, with windows at the contract's edges, and its
   time beside the plain version's and one advanced-indexing call's;
9. decode — the bitshuffle-to-frame kernel against its plain version at
   Eiger 16M, bit for bit and against the frames that went in: the planes
   of the six sample frames, a seeded Poisson frame with spots and a u32
   frame with 0xFFFFFFFF sentinels, all through the port's codec; its time
   beside its byte bound and the plain version's;
10. batched main path — the six sample frames as a /dev/shm-style stream
   dump, through the ``spotfinder`` CLI with ``--precision f32 --batch 4``,
   host and device decode, both algorithms: the anchors, no fallback
   notice, and the decode, dispersion and extended kernels launched once
   per batch; the golden through ``collect_batch`` from frames and from
   planes; the processor's steady batched frames/s and per-batch upload
   time beside the per-frame path's;
11. rowcum — both rowcum threshold entries (``dispersion_fused``,
   ``dispersion_extended_fused``) against their plain versions bit for bit
   on full Eiger 16M frames (sample images 2 and 5, the seeded Poisson and
   u32-sentinel frames, the stage tool's B = 8 batch), with and without the
   mask box count and the strong plane; ``compact_from_rowcum`` and
   ``compact_from_words`` on image 2 give ``compact_from_pcw``'s 9506
   pixels; then the stage tool's main (``ffs_tpu_torch.tools.
   measure_stages``, rowcum and packed rows) with both launch counters
   rising, and its per-frame and flat pixel lists and spot tables equal to
   a run on the plain thresholds; times beside the bound and the plain
   version;
12. gather variants — the lane-packed, plane-last and probe (double and
   single) gathers against their plain versions bit for bit at the gather
   tool's shapes and the integrator's, with windows at the contract's
   edges and an x0 % 4 != 0; times beside the bound, the plain version and
   one advanced-indexing call; the probe's TMA ring over single_only x
   r in (1, 3, 8, 16) x slots in (2, 4, 8, 16) wherever its planner admits
   the pair (ptxas's registers and shared memory of both forms; a line a
   pair with its stage bytes, bytes in flight and CUDA's occupancy query,
   bit-equal, its kernel time beside the plane-first kernel's at the same
   shapes); then the gather tool's main
   (``ffs_tpu_torch.tools.measure_window_gather``) with its bitwise
   assertions and the three launch counters rising;
13. SSX indexing — ``tools/bench_ssx.py``'s 64 stills (the port's copy of
   the adversarial suite's generators, ten noise spots each, a
   32768-direction search) through ``SSXIndexer.index`` one image a call
   (the PIA's shape) and ``index_batch`` at B = 64 (the bench's): images/s
   against the bar of 100, the stage split, CUDA-event times of the score +
   top-k and the refinement, the device's busy share over one batch; the
   same images through the float64 host search must index the same images
   with cells within 1e-4;
14. rotation indexing — a seeded sweep of ``tests/test_indexer_cli.py``'s
   crystal at Eiger 16M geometry (>= 20,000 strong reflections) through the
   indexer's core (``index_experiment``): the cell within 1% of the truth;
   the 256^3 complex128 FFT on the card against NumPy's (1e-12 of the
   peak), with both times and the whole index's;
15. the PIA hook — the ``spotfinder`` CLI's ``--output-for-index`` pipe
   lines on the six sample frames through ``index_pipe_payload`` with an
   armed indexer: every line comes back with ``lattices`` and
   ``n_unindexed``, the indexed and unindexed counts adding up to its spots;
16. ``--bg-device`` — (a) phase 7's collection through
   ``integrate_experiment`` on the host and the device path, both
   background models: device bounding boxes equal to the host's bit for
   bit, accumulators equal to phase 7's, every column within 1e-12 of the
   host path (integers exactly), the gathers launched as the run's chunks
   say; stage times of both paths; (b) the whole 3600-image sweep (~1.63M
   predictions on the card): device bounding boxes against the host's on
   every row, seeded histograms (with edge rows) and accumulators through
   the device backgrounds and finalisation at that N against the host
   functions on the first HOST_ROWS rows (the GLM on the first
   GLM_HOST_ROWS: the edge rows and the Poisson rows after them), both
   timed, and the device stages' share of an estimated ``integrate()`` of
   the sweep; (c) ``baseline_predictor_torch`` (``predictor.run``) on a
   360-image scan of the sweep's configuration, its table equal to
   ``predict_rotation``'s exactly;
17. multi-device — ``ffs_tpu_torch.parallel`` over ``min(cards, 4)``
   ranks, NCCL with one rank a card (on one card: 2 ranks share cuda:0 over
   gloo, the collectives through host memory), each rank a process of
   ``parallel.launch.run_ranks``: (a) ``sharded_spotfind_counts``,
   ``sharded_packed_pipeline`` and ``sharded_packed_pipeline_planes`` on
   the stage tool's B = 8 Eiger 16M batch and its bitshuffle planes; (b)
   ``sharded_packed_sp_pipeline``, plain and extended, and
   ``halo_sharded_dispersion`` on a seeded Jungfrau 4M frame with spots
   across every shard boundary; (c) ``sharded_kabsch_block_step`` on the
   first chunk of phase 7's collection (A = 2048, F = 4), each rank setting
   up its own rows (``sharded_chunk_setup``); (d)
   ``sharded_rotation_compact`` and the host 3D merge on the batch with a
   spot across every rank-boundary frame pair.  Each output equals the
   single-device path on cuda:0 bit for bit (the spot tables column by
   column, the eight Kabsch outputs, the Spots3D), on every rank; prints
   world, backend, each part's ms, the merge rounds, one halo exchange's
   ms and the DP frames/s beside world 1's; each rank's kernel launches
   (counted from 0 in that rank just before its part) must be above 0 for
   all five kernels.  They stand in the kernels line as ``multi_launches``
   (one count a rank), apart from ``launches``, the main paths' counts.
   ``python3 chip_smoke.py --multi-only`` runs phases 1, 2 and 17 alone
   (phase 7's integrator set up without its checks), for a machine with
   several cards, and ends with a line of its own: no kernels line and no
   ``{"ok": ...}`` line.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, without that line, on
any failure.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SIDE = 4362, 4148  # Eiger 16M (H, W)
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s
F32_OPS_PER_MS = 67e9  # H100 SXM float32 outside the tensor cores, 67 TFLOP/s
# float32 operations per pixel the threshold needs, at least.  Window counts
# of the mask and of the background are integers, and so is every test on
# them alone (m > 1, m >= min_count, n > 0, the root of 2(m-1)): integer
# work, not counted.  The first pass: I^2 (1), the 7x7 sums of I and I^2
# done separably (2 x 12 adds), the variance test m*y - x*x - x*(m-1) >
# x*nsig_b*root (3 products, 2 subtractions, 2 products, a compare) and
# I <= trusted_max (1): 34.  Dispersion adds the signal test m*I - x >
# nsig_s*sqrt(x*m) (3 products, a subtraction, a root, a compare): 40.
# Extended has no signal test; it adds the separable 11x11 sum of the
# background's I (2 x 10 adds) and the mean test I > 0, I >= x/n +
# nsig_s*sqrt(x/n) (a division, a root, a product, an add, 2 compares): 60.
DISPERSION_OPS_PER_PX = {"dispersion_packed": 40, "dispersion_extended_packed": 60}

# the integrator slice: an Eiger 16M at 200 mm, lambda 0.976 A, a thaumatin
# cell, 0.1 degree images; 40 images of a 3600-image sweep, cut for time
N_IMAGES = 40
CELL = (57.78, 57.78, 150.0)
SIGMA_B_DEG, SIGMA_M_DEG = 0.02, 0.05  # ~21x21-px shoeboxes ~4 images deep
SPOT_COUNTS, SPOT_SIGMA_PX, SPOT_SIGMA_Z = 2000.0, 1.2, 0.5
# reflection-image slices per second at the detector's 500 Hz:
# 464 predictions per image, each ~4 images deep
REAL_TIME_SLICES = 464 * 4 * 500


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.lru_cache(maxsize=None)
def seeded_frames():
    """(name, frame, mask) test inputs at Eiger 16M besides the samples."""
    from ffs_tpu_torch.io import sample_data

    rng = np.random.default_rng(20261016)
    h, w = SIDE
    mask = sample_data.generate_mask()
    frame = rng.poisson(4.0, size=(h, w)).astype(np.uint16)
    ys = rng.integers(8, h - 8, 3000)
    xs = rng.integers(8, w - 8, 3000)
    for y, x in zip(ys, xs):
        frame[y - 2 : y + 3, x - 2 : x + 3] += rng.poisson(60, size=(5, 5)).astype(np.uint16)
    frame[mask == 0] = 0
    u32 = rng.poisson(30.0, size=(h, w)).astype(np.uint32)
    u32[ys[:500], xs[:500]] += 100000
    u32[ys[500:600], xs[500:600]] = 0xFFFFFFFF  # saturation sentinels
    u32[mask == 0] = 0xFFFFFFFF  # gap sentinels under the mask
    return [("poisson_u16", frame, mask), ("sentinel_u32", u32, mask)]


def straddling_frame(dev) -> tuple[str, np.ndarray, np.ndarray]:
    """A seeded Eiger 16M u16 frame whose 5x5 Poisson(80) spots sit on every
    strip boundary column and segment boundary row (and their crossings) of
    both walkers' single-frame launches, over a Poisson(4) background and
    the sample mask."""
    import torch

    from ffs_tpu_torch.io import sample_data
    from ffs_tpu_torch.ops import dispersion_extended_packed as dxp
    from ffs_tpu_torch.ops import dispersion_packed as dp

    h, w = SIDE
    rng = np.random.default_rng(20261017)
    cols, rows = set(), set()
    probe = torch.empty((1, h, w), dtype=torch.uint16, device=dev)
    for t in (dp.launch_tiling(probe, 3, False, True),
              dp.launch_tiling(probe, dxp.HALO, True, False)):
        cols |= {s * t.wps * 32 for s in range(1, t.strips)}
        rows |= {g * t.seg_rows for g in range(1, t.segs)}
    centres = [(y, x) for y in sorted(rows) for x in range(7, w - 7, 53)]
    centres += [(y, x) for x in sorted(cols) for y in range(7, h - 7, 47)]
    centres += [(y, x) for y in sorted(rows) for x in sorted(cols)]
    frame = rng.poisson(4.0, size=(h, w)).astype(np.uint16)
    for y, x in centres:
        box = frame[max(y - 2, 0) : y + 3, x - 2 : x + 3]
        box += rng.poisson(80, size=box.shape).astype(np.uint16)
    mask = sample_data.generate_mask()
    frame[mask == 0] = 0
    return "straddle_u16", frame, mask


@functools.lru_cache(maxsize=None)
def jungfrau_batch(b: int = 112, seed: int = 5) -> tuple[np.ndarray, np.ndarray]:
    """(frames, mask): b seeded 1066 x 1030 u16 frames with 60 3x3 spots each
    over a Poisson(2) base and a 42-row module gap band: the JAX bench's
    Jungfrau 1M batch (bench.py), through the stage tool's generator."""
    from ffs_tpu_torch.tools.measure_stages import make_batch

    mask = np.ones((1066, 1030), np.uint8)
    mask[533 : 533 + 42] = 0
    return make_batch(b, mask, spots=60, seed=seed), mask


def phase_kernels(dev):
    """Every kernel against its plain version; returns per-kernel max error."""
    import torch

    from ffs_tpu_torch.io import sample_data
    from ffs_tpu_torch.ops import dispersion_extended_packed as dxp
    from ffs_tpu_torch.ops import dispersion_packed as dp

    mask_np = sample_data.generate_mask()
    inputs = [
        (f"sample_{i}", sample_data.generate_sample_image(i), mask_np) for i in (2, 5)
    ] + seeded_frames() + [straddling_frame(dev)]
    kernels = {
        "dispersion_packed": (dp.dispersion_packed_raw, dp.dispersion_packed_plain, dp.mask_box_count),
        "dispersion_extended_packed": (
            dxp.dispersion_extended_packed_raw,
            dxp.dispersion_extended_packed_plain,
            dxp.mask_box_count_extended,
        ),
    }
    max_err = {name: 0 for name in kernels}
    for tag, frame, mask in inputs:
        img = torch.from_numpy(frame).to(dev)
        msk = torch.from_numpy(mask).to(dev)
        tm = 65535.0 if frame.dtype == np.uint16 else 1.0e6
        for name, (raw, plain, mbox_fn) in kernels.items():
            want = plain(img, msk, tm)
            for mbox in (None, mbox_fn(msk)):
                got = raw(img, msk, tm, mbox=mbox)
                torch.cuda.synchronize()
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                max_err[name] = max(max_err[name], err)
                nwl = got.shape[-1] // 2
                px = int(got[:, nwl - 1].sum())
                say(
                    f"kernel {name:27s} {tag:13s} mbox={mbox is not None!s:5s} "
                    f"strong px {px:6d}  bit-equal {err == 0}"
                )
                if err:
                    fail(f"{name} on {tag} differs from its plain version (max |diff| {err})")
    return max_err


def check_golden(golden, tag: str, w: int, lin, inten, table) -> list[str]:
    """One frame's pixel list and host spot table against the golden; the
    mismatches as strings (none: bit-parity).  Integer columns (pixel
    coordinates and intensities, pixel counts, boxes, peaks and their
    intensity, the integer-valued intensity sums) must be equal; the two
    centres of mass are float32 quotients of exact sums, so they get a
    relative band of 1e-5 against the float64 golden."""
    errs = []
    y, x = lin // w, lin % w
    if len(lin) != len(golden[f"{tag}_y"]):
        return [f"{tag}: pixel count {len(lin)} != {len(golden[f'{tag}_y'])}"]
    if not (np.array_equal(y, golden[f"{tag}_y"]) and np.array_equal(x, golden[f"{tag}_x"])):
        errs.append(f"{tag}: strong-pixel coordinate list differs")
    if not np.array_equal(inten.astype(np.int64), golden[f"{tag}_intensity"].astype(np.int64)):
        errs.append(f"{tag}: strong-pixel intensities differ")
    if table.n_spots != len(golden[f"{tag}_n_pixels"]):
        return errs + [f"{tag}: spot count {table.n_spots} != {len(golden[f'{tag}_n_pixels'])}"]
    for col in ("n_pixels", "x_min", "x_max", "y_min", "y_max", "peak_x", "peak_y",
                "peak_intensity"):
        got = np.asarray(getattr(table, col)).astype(np.int64)
        if not np.array_equal(got, golden[f"{tag}_{col}"].astype(np.int64)):
            errs.append(f"{tag}: column {col} differs")
    got = np.asarray(table.sum_intensity).astype(np.float64)
    if not np.array_equal(got, golden[f"{tag}_sum_intensity"].astype(np.float64)):
        errs.append(f"{tag}: column sum_intensity differs")
    for col in ("com_x", "com_y"):
        got = np.asarray(getattr(table, col)).astype(np.float64)
        if not np.allclose(got, golden[f"{tag}_{col}"].astype(np.float64), rtol=1e-5, atol=1e-4):
            errs.append(f"{tag}: column {col} outside the float32 band")
    return errs


def run_cli(args: list[str]):
    """The port's CLI in-process; returns (rc, log, pipe JSON lines, seconds)."""
    from ffs_tpu_torch.pipeline import spotfinder

    import threading

    r, w = os.pipe()
    buf = io.StringIO()
    lines: list = []

    def read():  # drains the pipe while run() writes (a line can outgrow its buffer)
        with os.fdopen(r) as f:  # ends when run() closes the write end
            lines.extend(json.loads(line) for line in f if line.strip())

    reader = threading.Thread(target=read)
    reader.start()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = spotfinder.run(args + ["--pipe_fd", str(w)])
    seconds = time.perf_counter() - t0
    reader.join()
    return rc, buf.getvalue(), lines, seconds


def phase_main_path():
    """The CLI on the six sample frames; returns ({run: (CLI fps, seconds)},
    {kernel: launches during these runs})."""
    import torch

    from ffs_tpu_torch.ops.dispersion_extended_packed import dispersion_extended_packed_raw
    from ffs_tpu_torch.ops.dispersion_packed import dispersion_packed_raw

    base = ["--sample", "--images", "6", "--wavelength", "0.976", "--min-spot-size", "1"]
    anchors = {
        "dispersion": {2: (9506, 9506), 5: (2388, 2311)},
        "dispersion_extended": {5: (3, None)},
    }
    fps = {}
    dispersion_packed_raw.launches = 0
    dispersion_extended_packed_raw.launches = 0
    for precision in ("f32", "f64"):
        for algo, want in anchors.items():
            rc, log, lines, seconds = run_cli(base + ["--precision", precision, "--algorithm", algo])
            if rc != 0:
                print(log)
                fail(f"CLI {precision} {algo} exited {rc}")
            if "Device: cuda" not in log:
                fail(f"CLI {precision} {algo} did not run on the CUDA device")
            by_frame = {ln["file-number"]: ln for ln in lines}
            if sorted(by_frame) != list(range(6)):
                fail(f"CLI {precision} {algo}: pipe lines for frames {sorted(by_frame)}")
            for img, (px, spots) in want.items():
                got = by_frame[img]
                if got["num_strong_pixels"] != px or (
                    spots is not None and got["n_spots_total"] != spots
                ):
                    fail(f"CLI {precision} {algo} image {img}: {got} != ({px}, {spots})")
            m = re.search(r"(\d+) images in ([\d.]+) s .*\(([\d.]+) fps\)", log)
            fps[f"{precision} {algo}"] = (float(m.group(3)), seconds)
            say(
                f"cli {precision} {algo:19s} anchors ok; "
                + " ".join(f"{k}:{v['num_strong_pixels']}/{v['n_spots_total']}" for k, v in sorted(by_frame.items()))
                + f"; CLI fps {m.group(3)}, run() {seconds:.2f} s"
            )
    torch.cuda.synchronize()
    launches = {
        "dispersion_packed": dispersion_packed_raw.launches,
        "dispersion_extended_packed": dispersion_extended_packed_raw.launches,
    }
    say(f"main-path kernel launches: {launches}")
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path never launched {name}")
    return fps, launches


def phase_golden(dev):
    """f32 pixel lists + host spot tables of images 2 and 5 vs the golden."""
    from ffs_tpu_torch.io import sample_data
    from ffs_tpu_torch.ops.cc2d_host import cc2d
    from ffs_tpu_torch.spotfind import SpotfindConfig, SpotfindProcessor

    golden = np.load(ROOT / "tests" / "data" / "bench_anchor_golden.npz")
    h, w = SIDE
    proc = SpotfindProcessor(
        w, h, sample_data.generate_mask(), 65535.0,
        SpotfindConfig(precision="f32", min_spot_size=1), device=dev,
    )
    if not (proc.use_kernel and proc.host_cc):
        fail("the f32 processor is not on the kernel + host CC path")
    for tag, idx in (("img2", 2), ("img5", 5)):
        res = proc.process_frame(idx, sample_data.generate_sample_image(idx))
        lin = res.pixels.linear_index.astype(np.int64)
        inten = res.pixels.intensity
        t = cc2d(lin, inten, w)
        s = t.n_spots
        errs = check_golden(golden, tag, w, lin, inten, t)
        if errs:
            fail("; ".join(errs))
        say(f"golden {tag}: {len(lin)} px, {s} spots, every column equal (incl. peak_intensity)")


def bound_ms(nbytes: int, ops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take: compulsory bytes over the memory
    rate or float32 operations over the peak rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_MS, ops / F32_OPS_PER_MS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profiled_ms(fn, reps: int, names: tuple[str, ...]) -> dict[str, float]:
    """Device ms a launch of the kernels whose names contain each of
    ``names``, over ``reps`` calls of ``fn`` (torch.profiler; absent if the
    profiler saw none).  Each callee here launches each named kernel once a
    call; the mean is over the records the profiler kept, so a dropped
    record does not read as a faster kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    sums = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        for n in names:
            if n in e.key:
                total, count = sums.get(n, (0.0, 0))
                sums[n] = (total + e.self_device_time_total / 1e3, count + e.count)
    return {n: total / count for n, (total, count) in sums.items()}


def device_text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def phase_times(dev):
    """Each threshold kernel and its plain version at Eiger 16M (sample image
    5, one frame a launch; the stage tool's B = 8 batch) and on the Jungfrau
    1M B = 112 batch, device ms by CUDA events and by the profiler, beside
    the bound from each call's bytes (frames and words; the mask once a
    launch) and operations.  Returns the one-frame figures for the summary."""
    import torch

    from ffs_tpu_torch.io import sample_data
    from ffs_tpu_torch.ops import dispersion_extended_packed as dxp
    from ffs_tpu_torch.ops import dispersion_packed as dp
    from ffs_tpu_torch.tools import measure_stages as ms

    mask_np = sample_data.generate_mask()
    msk = torch.from_numpy(mask_np).to(dev)
    jf_frames, jf_mask = jungfrau_batch()
    cases = (
        ("Eiger 16M x1", torch.from_numpy(sample_data.generate_sample_image(5)).to(dev), msk),
        ("Eiger 16M x8", torch.from_numpy(ms.make_batch(8, mask_np)).to(dev), msk),
        ("Jungfrau 1M x112", torch.from_numpy(jf_frames).to(dev),
         torch.from_numpy(jf_mask).to(dev)),
    )
    out = {}
    for name, raw, plain, walker in (
        ("dispersion_packed", dp.dispersion_packed_raw, dp.dispersion_packed_plain,
         "dispersion_walker"),
        ("dispersion_extended_packed", dxp.dispersion_extended_packed_raw,
         dxp.dispersion_extended_packed_plain, "extended_walker"),
    ):
        for tag, img, m in cases:
            out_t = raw(img, m, 65535.0)
            n = img.shape[0] if img.dim() == 3 else 1
            # compulsory bytes: the frames and the words, the mask once a launch
            nbytes = sum(t.numel() * t.element_size() for t in (img, m, out_t))
            bound = bound_ms(nbytes, DISPERSION_OPS_PER_PX[name] * img.numel())
            reps = 50 if n == 1 else 20 if n == 8 else 5
            kernel = lambda: raw(img, m, 65535.0)  # noqa: E731  (the processor's call)
            # plain, kernel, kernel, plain: the means of each pair
            p1 = cuda_ms(lambda: plain(img, m, 65535.0), 10 if n == 1 else 2)
            k1 = cuda_ms(kernel, reps)
            k2 = cuda_ms(kernel, reps)
            p2 = cuda_ms(lambda: plain(img, m, 65535.0), 10 if n == 1 else 2)
            prof = profiled_ms(kernel, reps, (walker, "pc_scan"))
            k = (k1 + k2) / 2
            say(f"time {name} {tag}: kernel {k1:.4f} / {k2:.4f} ms a launch ({k / n:.5f} a frame), "
                f"profiler {prof.get(walker, float('nan')):.4f} walker + "
                f"{prof.get('pc_scan', float('nan')):.4f} scan ms a launch; plain {p1:.4f} / "
                f"{p2:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}, {nbytes} B), "
                f"{100 * bound[0] / k:.1f}% of it; {nbytes / k / 1e9:.3f} TB/s")
            if tag == "Eiger 16M x1":
                out[name] = (k, (p1 + p2) / 2, *bound)
    return out


def phase_processor(dev):
    """Steady per-frame processor rate on the six sample frames held in host
    memory (no sample generation in the loop), and one frame's stages."""
    import torch

    from ffs_tpu_torch.io import sample_data
    from ffs_tpu_torch.spotfind import SpotfindConfig, SpotfindProcessor

    h, w = SIDE
    mask = sample_data.generate_mask()
    frames = [sample_data.generate_sample_image(i) for i in range(6)]
    out = {}
    for precision in ("f32", "f64"):
        for algo in ("dispersion", "dispersion_extended"):
            cfg = SpotfindConfig(precision=precision, algorithm=algo, min_spot_size=1)
            proc = SpotfindProcessor(w, h, mask, 65535.0, cfg, device=dev)
            proc.process_frame(2, frames[2])  # warm: allocator, host CC library
            reps = 3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                for i, frame in enumerate(frames):
                    proc.process_frame(i, frame)
            torch.cuda.synchronize()
            fps = reps * len(frames) / (time.perf_counter() - t0)
            _, stages = proc.process_frame_profiled(2, frames[2])
            out[f"{precision} {algo}"] = fps
            say(
                f"processor {precision} {algo:19s}: {fps:.1f} frames/s; image 2 stages "
                + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items())
            )
    return out


def eiger_experiment(seed: int = 20261016, n_images: int | None = None):
    """The integrator's configuration: a thaumatin crystal in a seeded
    orientation on an Eiger 16M at 200 mm, lambda 0.976 A, ``n_images``
    (by default N_IMAGES) images of 0.1 degrees."""
    from ffs_tpu_torch.models.crystal import Crystal
    from ffs_tpu_torch.models.experiment import Experiment
    from ffs_tpu_torch.models.geometry import Goniometer, MonochromaticBeam, Scan, simple_panel

    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    cell = np.diag(CELL) @ q.T  # rows: the rotated real-space axes
    h, w = SIDE
    return Experiment(
        beam=MonochromaticBeam(wavelength=0.976),
        panel=simple_panel(200.0, (w / 2, h / 2), (0.075, 0.075), (w, h)),
        goniometer=Goniometer(),
        scan=Scan(image_range=(1, n_images or N_IMAGES), oscillation=(0.0, 0.1)),
        crystal=Crystal(*cell),
    )


class HostFrames:
    """A frame reader over u16 frames held in host memory."""

    def __init__(self, frames: np.ndarray, mask: np.ndarray):
        self.frames, self.mask = frames, mask

    def get_image(self, n):
        return self.frames[n]

    def get_mask(self):
        return self.mask

    def get_number_of_images(self):
        return len(self.frames)


def synth_collection(expt, pred, mask: np.ndarray, dev, seed: int = 7):
    """Seeded frames of a rotation collection: Poisson(4) background drawn on
    the device, plus a Gaussian spot (SPOT_SIGMA_PX wide, SPOT_SIGMA_Z
    images deep, SPOT_COUNTS in total) at every prediction, built in a
    15x15 window per spot and image, as tests/test_integration.py builds
    them on whole frames; gaps are zero.  Returns (u16 frames on the host,
    the counts injected per reflection)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w, h = expt.panel.image_size
    n_img = expt.scan.image_range[1] - expt.scan.image_range[0] + 1
    px, py, pz = (torch.from_numpy(c).to(dev) for c in pred.xyzcal_px.T)
    norm = 2 * np.pi * SPOT_SIGMA_PX**2 * np.sqrt(2 * np.pi) * SPOT_SIGMA_Z
    half = 7
    off = torch.arange(-half, half + 1, device=dev)
    ix = torch.floor(px).long()[:, None, None] + off[None, None, :]  # (N, 1, 15)
    iy = torch.floor(py).long()[:, None, None] + off[None, :, None]  # (N, 15, 1)
    g = torch.exp(-((ix - px[:, None, None]) ** 2 + (iy - py[:, None, None]) ** 2)
                  / (2 * SPOT_SIGMA_PX**2))
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    g = torch.where(inside, g, 0.0)
    ixc, iyc = ix.clamp(0, w - 1).expand_as(g), iy.clamp(0, h - 1).expand_as(g)
    keep = torch.from_numpy(mask != 0).to(dev)
    injected = torch.zeros(len(px), dtype=torch.float64, device=dev)
    frames = np.empty((n_img, h, w), np.uint16)
    for z in range(n_img):
        fz = torch.exp(-((z + 0.5 - (pz + 0.5)) ** 2) / (2 * SPOT_SIGMA_Z**2))
        sel = torch.nonzero(fz >= 1e-3).flatten()
        spot = SPOT_COUNTS * fz[sel, None, None] * g[sel] / norm
        injected.index_add_(0, sel, spot.sum(dim=(1, 2)))
        frame = torch.poisson(torch.full((h, w), 4.0, device=dev, dtype=torch.float64), gen)
        frame.index_put_((iyc[sel], ixc[sel]), spot, accumulate=True)
        frame = torch.where(keep, torch.round(frame), 0.0).clamp_(0, 65535)
        frames[z] = frame.to(torch.int32).cpu().numpy().astype(np.uint16)
    return frames, injected.cpu().numpy()


@contextlib.contextmanager
def plain_gathers():
    """Route the integrator's window gathers to their plain PyTorch versions
    (on any device) for the duration, for a reference run on the card."""
    from ffs_tpu_torch.integration import kabsch
    from ffs_tpu_torch.ops import window_gather as wg

    saved = kabsch.window_gather_planes, kabsch.window_gather
    kabsch.window_gather_planes, kabsch.window_gather = (
        wg.window_gather_planes_plain, wg.window_gather_plain)
    try:
        yield
    finally:
        kabsch.window_gather_planes, kabsch.window_gather = saved


ACC_FIELDS = ("fg_sum", "fg_count", "sum_ix", "sum_iy", "sum_iz", "bg_hist", "bg_overflow",
              "bg_count")


def phase_integrator(dev):
    """The integrator CLI's core on a seeded Eiger 16M collection; returns
    (collection, run output, stage seconds, main-path gather launches)."""
    import types

    import torch

    from ffs_tpu_torch.integration import kabsch
    from ffs_tpu_torch.integration.reference_kabsch import integrate_reference
    from ffs_tpu_torch.io import sample_data
    from ffs_tpu_torch.models.reflection_table import INTEGRATED_SUM
    from ffs_tpu_torch.ops import window_gather as wg
    from ffs_tpu_torch.pipeline.integrator import integrate_experiment
    from ffs_tpu_torch.prediction.rotation import predict_rotation

    # set-up: the collection's frames, with spots at the card's predictions
    t0 = time.perf_counter()
    expt = eiger_experiment()
    h, w = SIDE
    mask = sample_data.generate_mask()
    pred = predict_rotation(expt, device=dev)
    frames, injected = synth_collection(expt, pred, mask, dev)
    reader = HostFrames(frames, mask)
    say(f"integrator set-up: {N_IMAGES} images {h}x{w}, {len(pred.hkl)} predictions "
        f"({len(pred.hkl) / N_IMAGES:.0f} per image), {time.perf_counter() - t0:.1f} s")

    # the main path, with the gather counters read just after
    stage_t: dict[str, float] = {}
    t_last = time.perf_counter()

    def mark(stage: str) -> None:
        nonlocal t_last
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_t[stage] = stage_t.get(stage, 0.0) + (now - t_last)
        t_last = now

    buf = io.StringIO()
    wg.window_gather_planes.launches = 0
    wg.window_gather.launches = 0
    with contextlib.redirect_stdout(buf):
        out = integrate_experiment(
            expt, {}, reader, device=dev, sigma_b=np.deg2rad(SIGMA_B_DEG),
            sigma_m=np.deg2rad(SIGMA_M_DEG), profile=True, mark=mark,
        )
    mark("finalize")
    launches = {"window_gather_planes": wg.window_gather_planes.launches,
                "window_gather": wg.window_gather.launches}
    log = buf.getvalue()
    for line in log.splitlines():
        if line.startswith(("Monochromatic", "Integrating", "Summation", "Intensity",
                            "Mean I/sigma", "Background estimate", "min_zeta", "Shoebox fill")):
            say(f"integrator: {line}")
    integ = out.integrator
    say(f"integrator: box {integ.box_w}x{integ.box_h}, {integ.max_active} reflections per "
        f"chunk, {integ.chunk_setups} chunk set-ups, {integ.block_steps} block steps; "
        f"gather launches {launches}")

    # (d) the main path went through both kernels: the field and mask
    # windows once per chunk set-up, the frame windows once per block step
    want = {"window_gather_planes": integ.chunk_setups + integ.block_steps,
            "window_gather": integ.chunk_setups}
    if launches != want or min(launches.values()) == 0:
        fail(f"integrator gather launches {launches}, expected {want} (all above 0)")
    cols = out.columns
    if not (np.array_equal(cols["miller_index"], pred.hkl.astype(np.int32))
            and np.array_equal(cols["s1"], pred.s1)):
        fail("the integrator's predictions differ from the set-up's on the same card")

    # (a) bit for bit against a second run with the plain gathers
    acc_plain = kabsch.Accumulators.zeros(len(cols["s1"]))
    z0 = expt.scan.image_range[0]
    image_numbers = range(z0 - 1, z0 - 1 + N_IMAGES)
    with plain_gathers():
        integ.integrate(reader, image_numbers, acc_plain)
    for name in ACC_FIELDS:
        if not np.array_equal(getattr(out.acc, name), getattr(acc_plain, name)):
            fail(f"integrator accumulator {name} differs from the plain-gather run")
    say("integrator: all eight accumulators equal the plain-gather run bit for bit")

    # (b) the first reflections against the float64 oracle, exactly
    k = 256
    osc_start, osc_width = expt.scan.oscillation
    ref = integrate_reference(
        frames=frames, det_mask=mask, bboxes=integ.bboxes[:k], s1=integ.s1[:k],
        phi=integ.phi[:k], s0=expt.beam.s0, rotation_axis=expt.goniometer.rotation_axis,
        panel=expt.panel, wavelength=expt.beam.wavelength,
        phi_lows=np.deg2rad(osc_start + (np.asarray(image_numbers) - (z0 - 1)) * osc_width),
        d_osc=float(np.deg2rad(osc_width)), z_values=np.asarray(image_numbers, np.float64),
        delta_b=integ._delta_b, delta_m=integ._delta_m, algorithm=integ.algorithm,
    )
    for name in ACC_FIELDS:
        if not np.array_equal(getattr(out.acc, name)[:k], ref[name]):
            fail(f"integrator accumulator {name} differs from the float64 oracle "
                 f"on the first {k} reflections")
    if ref["fg_count"].sum() == 0:
        fail("the oracle's reflections have no foreground")
    say(f"integrator: the first {k} reflections equal the float64 oracle exactly "
        f"({int(ref['fg_count'].sum())} foreground pixels)")

    # (c) the injected intensities come back, away from the edges
    x, y, z = pred.xyzcal_px.T
    inner = (x > 20) & (x < w - 20) & (y > 20) & (y < h - 20) & (z > 1.5) & (z < N_IMAGES - 1.5)
    inner &= mask[y.astype(int), x.astype(int)] != 0
    valid = (cols["flags"] & np.uint64(INTEGRATED_SUM)) != 0
    share = float(valid[inner].mean())
    ratio = float(np.median(cols["intensity.sum.value"][inner & valid]
                            / injected[inner & valid]))
    say(f"integrator: {int(inner.sum())} reflections away from edges and gaps: valid share "
        f"{share:.4f}, median I/injected {ratio:.4f}")
    if not (share > 0.9 and ratio > 0.7):
        fail(f"integrated intensities off: valid share {share:.4f}, median ratio {ratio:.4f}")

    acc = kabsch.Accumulators.zeros(len(integ.s1))
    profile_device("integrator profile over 12 images",
                   lambda: integ.integrate(reader, image_numbers[:12], acc))

    z_lo = np.clip(integ.bboxes[:, 4], 0, N_IMAGES)
    z_hi = np.clip(integ.bboxes[:, 5], 0, N_IMAGES)
    slices = int(np.maximum(z_hi - z_lo, 0).sum())
    col = types.SimpleNamespace(expt=expt, pred=pred, frames=frames, mask=mask, slices=slices)
    return col, out, stage_t, launches


def profile_device(label: str, fn) -> None:
    """Where ``fn``'s time goes: torch.profiler over one call (outside any
    main path's counted run): the device's busy share of the wall time and
    the device time by kernel and copy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels and copies; the host ops that
    # launched them repeat their time, the profiler's own buffer requests
    # are not the program's)
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("Activity Buffer")]
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        say(f"{label}: the profiler saw no device time (not measured)")
        return
    say(f"{label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    for ms, count, key in sorted(rows, reverse=True)[:10]:
        say(f"    {ms:9.2f} ms {count:6d}x  {key[:90]}")


def gather_cases(integ, frames_host):
    """(name, wrapper, plain, image, bh, y0, x0) at the main path's shapes:
    the first chunk's windows, with the contract's edges (x0 = Wp-129 and
    the bottom-most y0) in the first two windows."""
    import torch

    from ffs_tpu_torch.ops import window_gather as wg

    a = integ.max_active
    order = np.argsort(integ.bboxes[:, 4], kind="stable")[:a]
    x0 = np.resize(integ.bboxes[order, 0], a)
    y0 = np.resize(integ.bboxes[order, 2], a)
    frames = integ.pad_frames(
        torch.from_numpy(np.stack(frames_host[: integ.frame_block])).to(integ.device))
    cases = []
    for name, fn, plain, img, bh in (
        ("frames", wg.window_gather_planes, wg.window_gather_planes_plain, frames, integ.box_h),
        ("corner field", wg.window_gather_planes, wg.window_gather_planes_plain,
         integ.corner_field_f32(), integ.box_h + 8),
        ("mask", wg.window_gather, wg.window_gather_plain, integ._mask_canvas, integ.box_h),
    ):
        hp, wp = img.shape[-2:]
        yy, xx = y0.copy(), x0.copy()
        xx[0], yy[1] = wp - 129, hp - bh
        cases.append((name, fn, plain, img, bh, yy, xx))
    return cases


def phase_gathers(dev, integ, frames_host):
    """Both gather kernels against their plain versions at the main path's
    shapes, bit for bit, with times; returns {kernel: figures} for the
    summary (the frame windows for the planes kernel)."""
    import torch

    from ffs_tpu_torch.ops import window_gather as wg

    out = {}
    for name, fn, plain, img, bh, y0, x0 in gather_cases(integ, frames_host):
        want = plain(img, y0, x0, bh=bh)
        got = fn(img, y0, x0, bh=bh)
        torch.cuda.synchronize()
        err = int((got.view(torch.int32).to(torch.int64)
                   - want.view(torch.int32).to(torch.int64)).abs().max())
        say(f"gather {name:12s} {tuple(got.shape)} {str(got.dtype):13s} bit-equal {err == 0}")
        if err or got.shape != want.shape or got.dtype != want.dtype:
            fail(f"the {name} gather differs from its plain version (max |bit diff| {err})")
        # the kernel alone: offsets on the card and the output allocated once
        # (the wrapper adds the contract check and the offsets' upload)
        entry = "ffs_window_gather_planes" if img.dim() == 3 else "ffs_window_gather"
        y0_d, x0_d = wg._device_offsets(y0, x0, dev)
        kernel = lambda: wg._launch(entry, img, y0_d, x0_d, bh, got)  # noqa: E731
        rows, cols = wg.window_index(y0, x0, bh, img.device)
        if img.dim() == 3:
            library = lambda: img[:, rows, cols]  # noqa: E731
        else:
            library = lambda: img[rows, cols]  # noqa: E731
        p1 = cuda_ms(lambda: plain(img, y0, x0, bh=bh), 10)
        k1 = cuda_ms(kernel, 50)
        lib_ms = cuda_ms(library, 20)
        wrapper_ms = cuda_ms(lambda: fn(img, y0, x0, bh=bh), 20)
        k2 = cuda_ms(kernel, 50)
        p2 = cuda_ms(lambda: plain(img, y0, x0, bh=bh), 10)
        # compulsory bytes: the windows overlap, so the image elements under
        # their union, read once; each window element written once; the two
        # offset arrays read once
        covered = torch.zeros(img.shape[-2:], dtype=torch.bool, device=dev)
        covered[rows, cols] = True
        planes = img.shape[0] if img.dim() == 3 else 1
        read = int(covered.sum()) * planes * img.element_size()
        written = got.numel() * got.element_size()
        nbytes = read + written + 2 * 4 * len(y0)
        bound = bound_ms(nbytes)
        say(f"time gather {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
            f"one advanced-indexing call {lib_ms:.4f} ms, wrapper {wrapper_ms:.4f} ms, "
            f"bound {bound[0]:.4f} ms ({read} B read under the windows' union, {written} B "
            f"written, {nbytes} B in all); {nbytes / ((k1 + k2) / 2) / 1e9:.3f} TB/s")
        key = fn.__name__
        if key not in out:  # the frames for the planes kernel, the mask for the other
            out[key] = {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                        "bound": bound, "library_ms": lib_ms}
        else:
            out[key]["max_abs_err"] = max(out[key]["max_abs_err"], err)
    return out


@functools.lru_cache(maxsize=None)
def sample_frames() -> np.ndarray:
    """The six sample frames, (6, H, W) u16."""
    from ffs_tpu_torch.io import sample_data

    return np.stack([sample_data.generate_sample_image(i) for i in range(6)])


def to_planes(frames: np.ndarray) -> tuple[list[bytes], np.ndarray]:
    """Each frame through the port's codec: its bitshuffle-LZ4 chunk, and
    the stacked LZ4-decoded block planes (B, n_blocks, block_bytes) u8 that
    device decode uploads (the final partial block re-spread, zero padded)."""
    from ffs_tpu_torch.io import compression

    s = frames.dtype.itemsize
    chunks = [compression.bshuf_lz4_compress(f, s) for f in frames]
    planes = [compression.bshuf_lz4_planes(c, frames[0].size, s)[0] for c in chunks]
    return chunks, np.stack(planes)


def bit_err(got, want) -> int:
    """Largest |difference| of two unsigned pixel tensors, read through
    same-width signed views (PyTorch's uint16/uint32 lack CUDA ops)."""
    import torch

    sgn = torch.int16 if got.element_size() == 2 else torch.int32
    bits = 8 * got.element_size()
    a = got.view(sgn).to(torch.int64) & ((1 << bits) - 1)
    b = want.view(sgn).to(torch.int64) & ((1 << bits) - 1)
    return int((a - b).abs().max())


def phase_decode(dev, sample_planes: np.ndarray):
    """The decode kernel against its plain version, and both against the
    frames that went into the codec; returns the summary's figures, timed
    at the batched main path's shape (four u16 frames a launch)."""
    import torch

    from ffs_tpu_torch.ops import bitshuffle_device as bd

    (_, poisson, _), (_, u32, _) = seeded_frames()
    inputs = [("sample frames", sample_frames(), sample_planes)]
    inputs += [(tag, f[None], to_planes(f[None])[1]) for tag, f in
               (("poisson_u16", poisson), ("sentinel_u32", u32))]
    max_err = 0
    for tag, frames, planes in inputs:
        h, w = frames.shape[1:]
        tdt = torch.uint16 if frames.dtype == np.uint16 else torch.uint32
        p = torch.from_numpy(planes).to(dev)
        want = bd.frames_from_planes_plain(p, h, w, tdt)
        got = bd.frames_from_planes(p, h, w, tdt)
        torch.cuda.synchronize()
        err = bit_err(got, want)
        max_err = max(max_err, err)
        back = bit_err(got, torch.from_numpy(frames.view(np.int16 if tdt == torch.uint16
                                                          else np.int32)).to(dev).view(tdt))
        say(f"decode {tag:13s} planes {tuple(planes.shape)} -> {tuple(got.shape)} {tdt}: "
            f"bit-equal to plain {err == 0}, to the frames {back == 0}")
        if err or back or got.dtype != tdt or tuple(got.shape) != frames.shape:
            fail(f"decode of {tag}: |diff| {err} to the plain version, {back} to the frames")

    times = {}
    for tag, planes, tdt in (("u16 x4", sample_planes[:4], torch.uint16),
                             ("u32 x1", inputs[2][2], torch.uint32)):
        h, w = SIDE
        p = torch.from_numpy(planes).to(dev)
        kernel = lambda: bd.frames_from_planes(p, h, w, tdt)  # noqa: E731
        plain = lambda: bd.frames_from_planes_plain(p, h, w, tdt)  # noqa: E731
        nbytes = p.numel() + kernel().numel() * (2 if tdt == torch.uint16 else 4)
        bound = bound_ms(nbytes)
        p1 = cuda_ms(plain, 3)
        k1 = cuda_ms(kernel, 50)
        k2 = cuda_ms(kernel, 50)
        p2 = cuda_ms(plain, 3)
        n = planes.shape[0]
        say(f"time decode {tag}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms a "
            f"launch of {n} Eiger 16M frames; bound {bound[0]:.4f} ms ({bound[1]}, {nbytes} B); "
            f"{nbytes / ((k1 + k2) / 2) / 1e9:.3f} TB/s, {(k1 + k2) / 2 / n:.4f} ms a frame")
        times[tag] = {"max_abs_err": max_err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                      "bound": bound, "library_ms": None}
    return {"bitshuffle_frames": times["u16 x4"]}


def write_shm_dir(root: pathlib.Path, chunks: list[bytes], mask: np.ndarray) -> pathlib.Path:
    """A /dev/shm-style stream dump (io/shm.py's layout) of compressed u16
    Eiger 16M frames: a still collection, the sample mask as start_5."""
    h, w = SIDE
    header = {
        "nimages": len(chunks), "ntrigger": 1, "y_pixels_in_detector": h,
        "x_pixels_in_detector": w, "bit_depth_image": 16,
        "countrate_correction_count_cutoff": 65535, "wavelength": 0.976,
        "detector_distance": 500.0, "y_pixel_size": 7.5e-05, "x_pixel_size": 7.5e-05,
        "beam_center_y": h / 2, "beam_center_x": w / 2,
    }
    (root / "start_1").write_text(json.dumps(header))
    (root / "start_4").write_text("{}")
    (root / "start_5").write_bytes((mask == 0).astype(np.int32).tobytes())
    for i, chunk in enumerate(chunks):
        (root / f"image_{i:06d}_2").write_bytes(chunk)
    return root


def phase_batch_main_path(chunks: list[bytes]):
    """The CLI's batched path (--batch 4, host and device decode, both
    algorithms) over a stream dump of the six sample frames; returns
    {kernel: launches during these runs}."""
    import torch

    from ffs_tpu_torch.io import sample_data
    from ffs_tpu_torch.ops.bitshuffle_device import frames_from_planes
    from ffs_tpu_torch.ops.dispersion_extended_packed import dispersion_extended_packed_raw
    from ffs_tpu_torch.ops.dispersion_packed import dispersion_packed_raw

    anchors = {
        "dispersion": {2: (9506, 9506), 5: (2388, 2311)},
        "dispersion_extended": {5: (3, None)},
    }
    batch = 4
    n_batches = -(-len(chunks) // batch)  # the tail batch zero padded
    with tempfile.TemporaryDirectory(prefix="ffs_smoke_shm_") as tmp:
        d = write_shm_dir(pathlib.Path(tmp), chunks, sample_data.generate_mask())
        frames_from_planes.launches = 0
        dispersion_packed_raw.launches = 0
        dispersion_extended_packed_raw.launches = 0
        for decode in ("host", "device"):
            for algo, want in anchors.items():
                run = f"f32 --batch {batch} {decode} decode {algo}"
                rc, log, lines, seconds = run_cli([
                    str(d), "--precision", "f32", "--batch", str(batch), "--min-spot-size", "1",
                    "--algorithm", algo, "--decode-backend", decode])
                if rc != 0:
                    print(log)
                    fail(f"CLI {run} exited {rc}")
                if "Device: cuda" not in log or "unavailable" in log:
                    print(log)
                    fail(f"CLI {run} did not run the batched path on the CUDA device")
                by_frame = {ln["file-number"]: ln for ln in lines}
                if sorted(by_frame) != list(range(len(chunks))):
                    fail(f"CLI {run}: pipe lines for frames {sorted(by_frame)}")
                for img, (px, spots) in want.items():
                    got = by_frame[img]
                    if got["num_strong_pixels"] != px or (
                        spots is not None and got["n_spots_total"] != spots
                    ):
                        fail(f"CLI {run} image {img}: {got} != ({px}, {spots})")
                m = re.search(r"(\d+) images in ([\d.]+) s .*\(([\d.]+) fps\)", log)
                say(f"cli {run:44s} anchors ok; "
                    + " ".join(f"{k}:{v['num_strong_pixels']}/{v['n_spots_total']}"
                               for k, v in sorted(by_frame.items()))
                    + f"; CLI fps {m.group(3)}, run() {seconds:.2f} s")
        torch.cuda.synchronize()
        launches = {
            "bitshuffle_frames": frames_from_planes.launches,
            "dispersion_packed": dispersion_packed_raw.launches,
            "dispersion_extended_packed": dispersion_extended_packed_raw.launches,
        }
    # a launch per batch: decode in the device-decode runs only, each
    # threshold kernel in its algorithm's host and device-decode runs
    want = {"bitshuffle_frames": len(anchors) * n_batches,
            "dispersion_packed": 2 * n_batches, "dispersion_extended_packed": 2 * n_batches}
    say(f"batched main-path kernel launches: {launches}")
    if launches != want:
        fail(f"batched main-path launches {launches}, expected {want}")
    return launches


def phase_batch_golden(dev, sample_planes: np.ndarray):
    """Images 2 and 5 through collect_batch, from frames and from planes,
    against the golden; the device-CC batch equal to the host-CC one."""
    from ffs_tpu_torch.io import sample_data
    from ffs_tpu_torch.ops.cc2d_host import cc2d
    from ffs_tpu_torch.spotfind import SpotfindConfig, SpotfindProcessor

    golden = np.load(ROOT / "tests" / "data" / "bench_anchor_golden.npz")
    h, w = SIDE
    mask = sample_data.generate_mask()
    nums = [2, 3, 4, 5]
    frames, planes = sample_frames()[nums], sample_planes[nums]
    results = {}
    for cc_backend in ("auto", "device"):
        proc = SpotfindProcessor(
            w, h, mask, 65535.0,
            SpotfindConfig(precision="f32", min_spot_size=1, cc_backend=cc_backend), device=dev,
        )
        if not proc.batch_supported():
            fail("the f32 processor does not support batched collection on the card")
        for form, dispatch, data in (("frames", proc.dispatch_batch, frames),
                                     ("planes", proc.dispatch_batch_planes, planes)):
            res = proc.collect_batch(nums, dispatch(data), want_com=True)
            results[(cc_backend, form)] = res
            for tag, idx in (("img2", 2), ("img5", 5)):
                r = res[nums.index(idx)]
                lin = r.pixels.linear_index.astype(np.int64)
                errs = check_golden(golden, tag, w, lin, r.pixels.intensity,
                                    cc2d(lin, r.pixels.intensity, w))
                if errs:
                    fail(f"batch {cc_backend} CC from {form}: " + "; ".join(errs))
    ref = results[("auto", "frames")]
    for key, res in results.items():
        for a, b in zip(ref, res):
            same = (a.n_strong_pixels, a.n_spots, a.n_spots_prefilter,
                    a.n_strong_pixels_filtered) == (b.n_strong_pixels, b.n_spots,
                                                    b.n_spots_prefilter, b.n_strong_pixels_filtered)
            if not (same and np.array_equal(a.pixels.linear_index, b.pixels.linear_index)
                    and np.array_equal(a.pixels.root, b.pixels.root)):
                fail(f"batch {key} differs from the host-CC frame batch on image {a.image_number}")
    say("golden through collect_batch: img2 and img5 from frames and from planes, every "
        "column equal (incl. peak_intensity); device-CC batches equal the host-CC ones")


def phase_batch_times(dev, sample_planes: np.ndarray) -> None:
    """The processor's steady frames/s on the six sample frames held in host
    memory (f32 dispersion, host CC): batched from frames at B = 4 and 8,
    batched from planes at B = 4, and the per-frame tiered path, each with
    its upload's host-clock time (the fastest copy of a batch or frame).
    Five rounds, the order reversed every other round; then a device
    profile of one batched run from frames and one from planes."""
    import torch

    from ffs_tpu_torch.io import sample_data
    from ffs_tpu_torch.spotfind import SpotfindConfig, SpotfindProcessor

    h, w = SIDE
    proc = SpotfindProcessor(w, h, sample_data.generate_mask(), 65535.0,
                             SpotfindConfig(precision="f32", min_spot_size=1), device=dev)
    frames = sample_frames()
    passes = 3  # over the batches of a case in one timed run

    def clocked(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def batched(b, source, dispatch):
        # three batches that together hold every sample frame B/2 times
        stacks = [source[(np.arange(b) + k * b) % len(frames)] for k in range(3)]
        nums = list(range(b))

        def run():
            prev = None  # one batch in flight, as the CLI keeps it
            for _ in range(passes):
                for s in stacks:
                    cur = dispatch(s)
                    if prev is not None:
                        proc.collect_batch(nums, prev)
                    prev = cur
            proc.collect_batch(nums, prev)

        proc.collect_batch(nums, dispatch(stacks[0]))  # warm
        return passes * len(stacks) * b, run, stacks

    def per_frame():
        for _ in range(passes):
            for i, f in enumerate(frames):
                proc.process_frame(i, f)

    proc.process_frame(2, frames[2])  # warm
    cases = {
        "batch frames B=4": batched(4, frames, proc.dispatch_batch),
        "batch frames B=8": batched(8, frames, proc.dispatch_batch),
        "batch planes B=4": batched(4, sample_planes, proc.dispatch_batch_planes),
        "per-frame tiered": (passes * len(frames), per_frame, list(frames)),
    }
    fps = {name: [] for name in cases}
    upload = {name: [] for name in cases}
    for r in range(5):
        for name in (list(cases) if r % 2 == 0 else list(reversed(cases))):
            n, run, stacks = cases[name]
            fps[name].append(n / clocked(run))
            upload[name].append(1e3 * min(clocked(lambda s=s: proc._upload(s)) for s in stacks))
    for name, (n, run, stacks) in cases.items():
        rate = float(np.median(fps[name]))
        up = float(np.median(upload[name]))
        per = n // passes // len(stacks)  # frames a copy
        say(f"processor f32 dispersion {name}: median {rate:.1f} frames/s (runs "
            + ", ".join(f"{x:.1f}" for x in fps[name]) + f"); upload median {up:.2f} ms "
            f"({stacks[0].nbytes} B), {100 * up * rate / per / 1e3:.1f}% of the wall")
    for name in ("batch frames B=4", "batch planes B=4"):
        n, run, _ = cases[name]
        profile_device(f"profile of {name} ({n} frames)", run)


def tensors_equal(a, b) -> bool:
    """Equal values, dtype and shape, for tensors (on any devices), numpy
    arrays, CompactPixels and spot tables alike (a NamedTuple compares field
    by field, tuples and lists item by item, anything else by ``==``)."""
    import torch

    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(
            tensors_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and bool(torch.equal(a, b.to(a.device))))
    return a == b


def phase_rowcum(dev):
    """Kernels 6 and 7 (the rowcum entries) against their plain versions at
    Eiger 16M, the rowcum and word compactions on image 2, then the stage
    tool's main path; returns ({kernel: figures}, {kernel: launches})."""
    import torch

    from ffs_tpu_torch.io import sample_data
    from ffs_tpu_torch.ops import compact
    from ffs_tpu_torch.ops import dispersion_extended_packed as dxp
    from ffs_tpu_torch.ops import dispersion_packed as dp
    from ffs_tpu_torch.tools import measure_stages as ms

    mask_np = sample_data.generate_mask()
    tool_frames = ms.make_batch(8, mask_np)  # the stage tool's seed-12 batch
    inputs = [(f"sample_{i}", sample_data.generate_sample_image(i), mask_np) for i in (2, 5)]
    inputs += seeded_frames() + [("tool batch B=8", tool_frames, mask_np)]
    max_err = {"dispersion_fused": 0, "dispersion_extended_fused": 0}
    for tag, frame, mask in inputs:
        img = torch.from_numpy(frame).to(dev)
        msk = torch.from_numpy(mask).to(dev)
        tm = 65535.0 if frame.dtype == np.uint16 else 1.0e6
        mbox = dp.mask_box_count(msk)
        for name, fused, plain, mboxes in (
            ("dispersion_fused", dp.dispersion_fused, dp.dispersion_fused_plain, (None, mbox)),
            ("dispersion_extended_fused", dxp.dispersion_extended_fused,
             dxp.dispersion_extended_fused_plain, (None,)),
        ):
            want_strong, want_rowcum = plain(img, msk, tm)
            for mb in mboxes:
                for emit in (True, False):
                    kw = {} if mb is None else {"mbox": mb}
                    strong, rowcum = fused(img, msk, tm, emit_strong=emit, **kw)
                    torch.cuda.synchronize()
                    err = int((rowcum.to(torch.int64) - want_rowcum.to(torch.int64)).abs().max())
                    if emit:
                        err = max(err, int((strong.to(torch.int64)
                                            - want_strong.to(torch.int64)).abs().max()))
                    elif strong is not None:
                        fail(f"{name} emit_strong=False returned a strong plane")
                    max_err[name] = max(max_err[name], err)
                    if err or rowcum.dtype != torch.int32 or rowcum.shape != img.shape:
                        fail(f"{name} on {tag} (mbox={mb is not None}, strong={emit}) differs "
                             f"from its plain version (max |diff| {err})")
            say(f"kernel {name:27s} {tag:14s} strong px {int(want_rowcum[..., -1].sum()):7d}  "
                f"bit-equal True (mbox {len(mboxes) > 1}, with and without strong)")

    # the rowcum and word compactions give the packed path's pixels
    img2 = torch.from_numpy(sample_data.generate_sample_image(2)).to(dev)
    msk = torch.from_numpy(mask_np).to(dev)
    _, rowcum = dp.dispersion_fused(img2, msk, 65535.0, emit_strong=False)
    from_rowcum = compact.compact_from_rowcum(img2, rowcum, max_pixels=32768)
    from_words = compact.compact_from_words(img2, *dp.dispersion_packed(img2, msk, 65535.0))
    from_pcw = compact.compact_from_pcw(img2, dp.dispersion_packed_raw(img2, msk, 65535.0))
    n = int(from_rowcum.count)
    if n != 9506 or not (tensors_equal(from_rowcum, from_pcw)
                         and tensors_equal(from_words, from_pcw)):
        fail(f"image 2 through the rowcum path: {n} px (want 9506), lists equal to "
             f"compact_from_pcw's: {tensors_equal(from_rowcum, from_pcw)}, words' "
             f"{tensors_equal(from_words, from_pcw)}")
    say("image 2: compact_from_rowcum and compact_from_words give compact_from_pcw's 9506 "
        "pixels, lists equal")

    # times at the tool's call: the B = 8 batch, no strong plane
    batch = torch.from_numpy(tool_frames).to(dev)
    figures = {}
    for name, kernel, plain in (
        ("dispersion_fused",
         lambda: dp.dispersion_fused(batch, msk, 65535.0, emit_strong=False),
         lambda: dp.dispersion_fused_plain(batch, msk, 65535.0, emit_strong=False)),
        ("dispersion_extended_fused",
         lambda: dxp.dispersion_extended_fused(batch, msk, 65535.0, emit_strong=False),
         lambda: dxp.dispersion_extended_fused_plain(batch, msk, 65535.0, emit_strong=False)),
    ):
        # compulsory bytes: the frames and the mask read once, rowcum written once
        nbytes = batch.numel() * 2 + msk.numel() + batch.numel() * 4
        ops_key = "dispersion_packed" if name == "dispersion_fused" else "dispersion_extended_packed"
        bound = bound_ms(nbytes, DISPERSION_OPS_PER_PX[ops_key] * batch.numel())
        p1 = cuda_ms(plain, 3)
        k1 = cuda_ms(kernel, 20)
        k2 = cuda_ms(kernel, 20)
        p2 = cuda_ms(plain, 3)
        figures[name] = {"max_abs_err": max_err[name], "ms": (k1 + k2) / 2,
                         "plain_ms": (p1 + p2) / 2, "bound": bound, "library_ms": None}
        say(f"time {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms a B=8 "
            f"Eiger 16M launch ({(k1 + k2) / 16:.4f} ms a frame); bound {bound[0]:.4f} ms "
            f"({bound[1]}, {nbytes} B); {nbytes / ((k1 + k2) / 2) / 1e9:.3f} TB/s")

    # the stage tool's main path, counters read just after
    counted = (dp.dispersion_fused, dxp.dispersion_extended_fused, dp.dispersion_packed_raw)
    for fn in counted:
        fn.launches = 0
    ms.main(reps=2, packed=False)
    ms.main(reps=2, packed=True)
    torch.cuda.synchronize()
    launches = {"dispersion_fused": dp.dispersion_fused.launches,
                "dispersion_extended_fused": dxp.dispersion_extended_fused.launches}
    say(f"stage tool main-path launches: {launches}, packed rows' dispersion_packed "
        f"{dp.dispersion_packed_raw.launches}")
    if min(launches.values()) == 0 or dp.dispersion_packed_raw.launches == 0:
        fail(f"the stage tool's main path did not launch every threshold kernel: {launches}")

    # its kernel-path outputs against a run on the plain thresholds
    ctx = ms.StageContext.build(mask_np, dev)
    ctx_plain = ms.StageContext.build(mask_np, dev, plain=True)
    for fn in (ms.k_full, ms.flat_full, ms.pk_full, ms.ext_only):
        for i in (0, 1):
            _, got = fn(i, batch, ctx)
            _, want = fn(i, batch, ctx_plain)
            if not tensors_equal(tuple(got), tuple(want)):
                fail(f"stage tool {fn.__name__}(i={i}): the kernel path's pixel lists or spot "
                     "tables differ from the plain path's")
    say("stage tool: per-frame and flat pixel lists, roots, spot tables and filters (rowcum "
        "and packed rows) and the extended rowcum equal the plain thresholds' run, i = 0 and 1")
    for fn in (ms.k_full, ms.flat_full):
        profile_device(f"profile of the stage tool's {fn.__name__} (B=8)",
                       lambda fn=fn: fn(1, batch, ctx))
    return figures, launches


def variant_index(fn, kw, y0, x0, bh: int, wp: int, dev):
    """(rows, cols) of the source pixel each output element of a gather
    variant copies, broadcastable to its (A', bh, 128) window layout."""
    import torch

    from ffs_tpu_torch.ops import window_gather as wg

    if fn is wg.window_gather_planes_packed:
        win = 4 * np.arange(len(y0) // 4)[:, None] + np.arange(128)[None, :] // 32
        rows = y0[win][:, None, :] + np.arange(bh)[None, :, None]
        cols = (x0[win] + np.arange(128) % 32)[:, None, :]
    else:
        rows = y0[:, None, None] + np.arange(bh)[None, :, None]
        cols = wg.probe_columns(x0, wp, kw.get("single_only", False))[:, None, :]
    return torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)


PROBE_R = (1, 3, 8, 16)
PROBE_SLOTS = (2, 4, 8, 16)


def window_bytes(img, rows, cols, out) -> tuple[int, int]:
    """A gather's compulsory bytes (read, written): the pixels of the
    (P, Hp, Wp) stack ``img`` under the union of what its windows copy,
    read once, and its output, written once."""
    import torch

    covered = torch.zeros(img.shape[-2:], dtype=torch.bool, device=img.device)
    covered[rows, cols] = True
    read = int(covered.sum()) * img.shape[0] * img.element_size()
    return read, out.numel() * out.element_size()


def probe_grid(dev, shape_tag: str, frames, y0, x0, bh: int) -> None:
    """The probe's TMA ring over single_only x r x slots at one shape: for
    every pair the planner admits, its stage, shared memory and bytes in
    flight beside CUDA's occupancy query, the result bit-equal to the plain
    version, and the kernel's time (CUDA events over back-to-back launches,
    and torch.profiler's device time) beside its bound and row 3's
    plane-first kernel at the same shapes (timed before and after the
    grid)."""
    import torch

    from ffs_tpu_torch.ops import window_gather as wg
    from ffs_tpu_torch.utils import cuda_build

    planes = frames.shape[0]
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    y0_d, x0_d = wg._device_offsets(y0, x0, dev)
    out = torch.empty((len(y0), planes, bh, 128), dtype=frames.dtype, device=dev)
    pf = lambda: wg._launch("ffs_window_gather_planes", frames, y0_d, x0_d, bh, out)  # noqa: E731
    pf_ms = [cuda_ms(pf, 200)]
    pf_dev = profiled_ms(pf, 50, ("gather_windows_kernel",)).get("gather_windows_kernel")
    rows = []
    for single in (False, True):
        want = wg.window_gather_probe_plain(frames, y0, x0, bh=bh, single_only=single)
        rows_i, cols_i = variant_index(wg.window_gather_probe, {"single_only": single}, y0, x0,
                                       bh, frames.shape[-1], dev)
        bound = bound_ms(sum(window_bytes(frames, rows_i, cols_i, want)) + 8 * len(y0))[0]
        for r in PROBE_R:
            for slots in PROBE_SLOTS:
                tag = (f"probe {shape_tag} {'single' if single else 'double'} r={r:2d} "
                       f"slots={slots:2d}")
                try:
                    plan = wg.probe_plan(planes, bh, r, slots, limit, single_only=single)
                except ValueError as e:
                    say(f"{tag}: not admitted ({e})")
                    continue
                with torch.cuda.device(dev):
                    occupancy = cuda_build.lib().ffs_window_gather_probe_blocks_per_sm(
                        int(single), plan.smem_bytes)
                if occupancy != plan.blocks_per_sm:
                    fail(f"{tag}: the planner counts {plan.blocks_per_sm} blocks an SM, CUDA's "
                         f"occupancy query {occupancy}")
                got = wg.window_gather_probe(frames, y0, x0, bh=bh, single_only=single, r=r,
                                             slots=slots)
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                    fail(f"{tag} differs from its plain version")
                extra = wg.probe_extra(single, r, slots, plan)
                kernel = lambda extra=extra: wg._launch(  # noqa: E731
                    "ffs_window_gather_probe", frames, y0_d, x0_d, bh, out, extra=extra)
                ms = cuda_ms(kernel, 200)
                dev_ms = profiled_ms(kernel, 50, ("gather_probe_kernel",)).get(
                    "gather_probe_kernel")
                rows.append((single, r, slots, ms, dev_ms))
                say(f"{tag}: bit-equal; stage {plan.stage_planes} plane(s) = {plan.stage_bytes} "
                    f"B, {plan.smem_bytes} B shared a block, blocks an SM {plan.blocks_per_sm} "
                    f"planned / {occupancy} CUDA's occupancy query, {plan.bytes_in_flight} B in "
                    f"flight an SM; kernel {ms:.4f} ms events, {device_text(dev_ms)} device "
                    f"(bound {bound:.4f} ms: {100 * bound / ms:.1f}% by events)")
    pf_ms.append(cuda_ms(pf, 200))
    say(f"row 3's plane-first kernel (ffs_window_gather_planes) at the {shape_tag}'s shapes: "
        f"{pf_ms[0]:.4f} / {pf_ms[1]:.4f} ms events, {device_text(pf_dev)} device")
    for single in (False, True):
        form = [row for row in rows if row[0] == single]
        best = min(form, key=lambda row: row[3])
        say(f"probe {shape_tag} {'single' if single else 'double'} best pair r={best[1]} "
            f"slots={best[2]}: "
            f"{best[3]:.4f} ms events, {device_text(best[4])} device, against the plane-first "
            f"kernel's {min(pf_ms):.4f} ms events, {device_text(pf_dev)} device")


def phase_gather_variants(dev, integ, frames_host):
    """Kernels 8-10 against their plain versions at the gather tool's shapes
    and the integrator's, with times at the tool's; then the gather tool's
    main path.  Returns ({kernel: figures}, {kernel: launches})."""
    import torch

    from ffs_tpu_torch.ops import window_gather as wg
    from ffs_tpu_torch.tools import measure_window_gather as mwg
    from ffs_tpu_torch.utils import cuda_build

    frames, y0, x0 = mwg.make_inputs(dev)
    hp, wp = frames.shape[-2:]
    y0, x0 = y0.astype(np.int64), x0.astype(np.int64)
    # the contract's edges, an aligned start, x0 % 4 == 1 (off TMA's 16-byte grid)
    x0[0], y0[1], x0[2], x0[3] = wp - 129, hp - mwg.BH, 256, 1029
    _, _, _, img_i, bh_i, y0_i, x0_i = gather_cases(integ, frames_host)[0]
    shapes = (("tool", frames, mwg.BH, y0, x0), ("integrator", img_i, bh_i, y0_i, x0_i))
    kernels = (
        ("window_gather_planes_packed", "ffs_window_gather_planes_packed",
         wg.window_gather_planes_packed, wg.window_gather_planes_packed_plain, {}),
        ("window_gather_planes_pl", "ffs_window_gather_planes_pl", wg.window_gather_planes_pl,
         wg.window_gather_planes_pl_plain, {}),
        ("window_gather_probe", "ffs_window_gather_probe", wg.window_gather_probe,
         wg.window_gather_probe_plain, {"single_only": False}),
        ("window_gather_probe single", "ffs_window_gather_probe", wg.window_gather_probe,
         wg.window_gather_probe_plain, {"single_only": True}),
    )
    figures = {}
    for shape_tag, img, bh, yy, xx in shapes:
        pl = mwg.to_pl(img)
        for name, entry, fn, plain, kw in kernels:
            src = pl if fn is wg.window_gather_planes_pl else img
            want = plain(src, yy, xx, bh=bh, **kw)
            got = fn(src, yy, xx, bh=bh, **kw)
            torch.cuda.synchronize()
            err = int((got.view(torch.int32).to(torch.int64)
                       - want.view(torch.int32).to(torch.int64)).abs().max())
            say(f"gather {name:27s} {shape_tag:10s} {tuple(got.shape)} bit-equal {err == 0}")
            if err or got.shape != want.shape or got.dtype != want.dtype:
                fail(f"{name} at the {shape_tag}'s shapes differs from its plain version "
                     f"(max |bit diff| {err})")
            if shape_tag != "tool":
                continue
            # times at the tool's shapes: the kernel alone (offsets on the
            # card, output allocated once) beside the plain version and one
            # advanced-indexing call over the same source pixels
            y0_d, x0_d = wg._device_offsets(yy, xx, dev)
            extra = {}
            if fn is wg.window_gather_planes_pl:
                extra = {"shape": src.shape[:3]}
            elif fn is wg.window_gather_probe:
                plan = wg.probe_plan(img.shape[0], bh, 8, 2, single_only=kw["single_only"])
                extra = {"extra": wg.probe_extra(kw["single_only"], 8, 2, plan)}
            kernel = lambda: wg._launch(entry, src, y0_d, x0_d, bh, got, **extra)  # noqa: E731
            rows, cols = variant_index(fn, kw, yy, xx, bh, wp, dev)
            if fn is wg.window_gather_planes_pl:
                cb, cl = cols // 128, cols % 128
                library = lambda: src[rows, cb, :, cl]  # noqa: E731
            else:
                library = lambda: src[:, rows, cols]  # noqa: E731
            p1 = cuda_ms(lambda: plain(src, yy, xx, bh=bh, **kw), 10)
            k1 = cuda_ms(kernel, 200)
            lib_ms = cuda_ms(library, 20)
            k2 = cuda_ms(kernel, 200)
            p2 = cuda_ms(lambda: plain(src, yy, xx, bh=bh, **kw), 10)
            kernel_name = {"ffs_window_gather_planes_packed": "gather_packed_kernel",
                           "ffs_window_gather_planes_pl": "gather_pl_kernel",
                           "ffs_window_gather_probe": "gather_probe_kernel"}[entry]
            dev_ms = profiled_ms(kernel, 200, (kernel_name,)).get(kernel_name)
            # compulsory bytes: the windows' union and the output; the offsets
            read, written = window_bytes(img, rows, cols, got)
            nbytes = read + written + 2 * 4 * len(yy)
            bound = bound_ms(nbytes)
            if fn.__name__ not in figures:  # the probe's row: its double form
                figures[fn.__name__] = {"max_abs_err": err, "ms": (k1 + k2) / 2,
                                        "plain_ms": (p1 + p2) / 2, "bound": bound,
                                        "library_ms": lib_ms}
            say(f"time gather {name}: kernel {k1:.4f} / {k2:.4f} ms (device {device_text(dev_ms)}"
                f"), plain {p1:.4f} / {p2:.4f} ms, one advanced-indexing call {lib_ms:.4f} ms, "
                f"bound {bound[0]:.4f} ms "
                f"({read} B read under the windows' union, {written} B written); "
                f"{nbytes / ((k1 + k2) / 2) / 1e9:.3f} TB/s")

    log = cuda_build.build_log().splitlines()
    for k, line in enumerate(log):
        if "Function properties for" in line and "gather_probe_kernel" in line:
            form = "single" if "ILb1E" in line else "double"
            ptxas = " ".join(x.split(":", 1)[-1].strip() for x in log[k + 1 : k + 3])
            say(f"ptxas gather_probe_kernel<{form}>: {ptxas}")
    for shape_tag, img, bh, yy, xx in shapes:
        probe_grid(dev, shape_tag, img, yy, xx, bh)
    profile_device("profile of one gather-tool pf rep (add, gather, sum)",
                   lambda: wg.window_gather_planes(frames + 1, y0, x0, bh=mwg.BH).sum())

    # the gather tool's main path, counters read just after
    counted = (wg.window_gather_planes_packed, wg.window_gather_planes_pl, wg.window_gather_probe)
    for fn in counted:
        fn.launches = 0
    mwg.main(reps=3)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    say(f"gather tool main-path launches: {launches}")
    if min(launches.values()) == 0:
        fail(f"the gather tool's main path did not launch every variant: {launches}")
    return figures, launches


# the indexing slice: phase 13 runs tools/bench_ssx.py's configuration (64
# stills of the adversarial suite's 30 x 40 x 50 A cell, ~50-300 spots with
# ten noise spots each, a 32768-direction search) against its bar of 100
# indexed images/s (tools/bench_ssx.py:10-14)
SSX_IMAGES = 64
SSX_BAR = 100.0
SSX_CELL_RTOL = 1e-4  # device (float32) against the float64 search, tests/test_torch_ssx.py
# phase 14: the rotation recipe of tests/test_indexer_cli.py (a 60 x 70 x 80 A
# orthorhombic crystal, lambda 1 A) at Eiger 16M geometry: 4148 x 4362 px of
# 75 um at 200 mm, 450 images of 0.1 degree
ROT_CELL = (60.0, 70.0, 80.0)
ROT_MIN_REFLECTIONS = 20000
# phase 15: the PIA's still indexer armed as a request at the sample
# geometry arms it; mu(Si, 0.97625 A) is the dx2 anchor the service's
# detector table reproduces (ffs_tpu_torch/service/detectors.py docstring)
PIA_WAVELENGTH, PIA_MU_SI = 0.97625, 3.92199
PIA_CELL = (78.9, 78.9, 38.1, 90.0, 90.0, 90.0)


def ssx_images():
    """tools/bench_ssx.py's stills, from the port's copy of the generators."""
    from ffs_tpu_torch.tools import ssx_adversarial as adv

    images = []
    for seed in range(SSX_IMAGES):
        crystal, panel, wavelength, s0, rng = adv.make_experiment(seed + 1)
        obs = adv.lattice_spots(crystal, panel, s0, rng)
        images.append(np.concatenate([obs, adv.noise_spots(rng, 10)]))
    return images, panel, wavelength


def ssx_success(results) -> list[bool]:
    """An image is indexed when a lattice of the known cell (3%) came back."""
    from ffs_tpu_torch.tools.ssx_adversarial import CELL

    return [r is not None and all(abs(g - w) / w < 0.03 for g, w in
                                  zip(sorted(r.cell_parameters[:3]), sorted(CELL[:3])))
            for r, _ in results]


def phase_ssx(dev, card: str) -> None:
    """Phase 13: SSX indexing at the service's size, per image (as the PIA
    calls it) and at B = 64 (as the bench tool does), held to the float64
    search on the same stills."""
    import torch

    from ffs_tpu_torch.indexing import ssx
    from ffs_tpu_torch.indexing.rlp import ssx_xyz_to_rlp
    from ffs_tpu_torch.tools.ssx_adversarial import CELL

    images, panel, wavelength = ssx_images()
    spots = [len(x) for x in images]

    def armed(**kw):
        ix = ssx.SSXIndexer(**kw)
        ix.panel, ix.cell, ix.wavelength = panel, CELL, wavelength
        return ix

    ix = armed(device=dev)
    ix.index_batch(images)  # warm: library handles, the direction table
    ix.index(images[0])
    t0 = time.perf_counter()
    per_image = [ix.index(x) for x in images]
    t_image = time.perf_counter() - t0
    t_batch = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch = ix.index_batch(images)
        t_batch.append(time.perf_counter() - t0)
    t_batch = sorted(t_batch)[1]
    ok_image, ok_batch = ssx_success(per_image), ssx_success(batch)
    for (ri, ni), (rb, nb) in zip(per_image, batch):
        if ni != nb or (ri is None) != (rb is None):
            fail("ssx: index() and index_batch() disagree on an image")
    say(f"ssx: {SSX_IMAGES} stills, {min(spots)}-{max(spots)} spots, 32768 directions; "
        f"indexed {sum(ok_image)}/{SSX_IMAGES}")
    say(f"ssx per image (PIA): {SSX_IMAGES / t_image:.1f} images/s "
        f"({1e3 * t_image / SSX_IMAGES:.2f} ms an image; bar {SSX_BAR:.0f} indexed images/s) on {card}")
    say(f"ssx B = {SSX_IMAGES} (bench): {SSX_IMAGES / t_batch:.1f} images/s "
        f"(median of 3 batches, {1e3 * t_batch:.1f} ms a batch; bar {SSX_BAR:.0f}) on {card}")

    stages: dict = {}
    ix.index_batch(images, timings=stages)
    total = sum(stages.values())
    say(f"ssx B = {SSX_IMAGES} stage split (host clock, device synchronised) on {card}: " + ", ".join(
        f"{k} {1e3 * v:.1f} ms ({100 * v / total:.0f}%)" for k, v in stages.items()))
    rlps = [ssx_xyz_to_rlp(x, panel, wavelength) for x in images]
    lengths = torch.tensor(CELL[:3], dtype=torch.float32, device=dev)
    dirs = ssx.device_dirs(32768, dev)
    for label, sel in ((f"B = {SSX_IMAGES}", rlps), ("B = 1", rlps[:1])):
        rlp_pad, w, n_real = ssx._pad_rlp_batch(sel)
        rlp_t, w_t = torch.from_numpy(rlp_pad).to(dev), torch.from_numpy(w).to(dev)
        v0 = torch.zeros((len(sel), 3, 32, 3), dtype=torch.float32, device=dev)
        v0[:, :, :, 2] = lengths[None, :, None]
        n_t = torch.from_numpy(n_real).to(dev)
        score_ms = cuda_ms(lambda: ssx.ssx_topk(rlp_t, w_t, lengths, dirs), reps=5)
        refine_ms = cuda_ms(lambda: ssx.ssx_refine(rlp_t, w_t, n_t, v0), reps=5)
        say(f"ssx {label} device stages (CUDA events, S = {rlp_pad.shape[1]}): score + top-k "
            f"{score_ms:.3f} ms, refine (40 steps) {refine_ms:.3f} ms on {card}")
    profile_device(f"ssx index_batch B = {SSX_IMAGES} on {card}", lambda: ix.index_batch(images))

    t0 = time.perf_counter()
    host = armed(use_device=False).index_batch(images)
    t_host = time.perf_counter() - t0
    ok_host = ssx_success(host)
    say(f"ssx float64 host search: indexed {sum(ok_host)}/{SSX_IMAGES} in {t_host:.1f} s "
        f"on the host of {card}")
    if sum(ok_host) != sum(ok_batch) or sum(ok_batch) != sum(ok_image):
        fail(f"ssx: success {sum(ok_batch)} (B = 64) / {sum(ok_image)} (per image) against "
             f"{sum(ok_host)} for the float64 search")
    worst = 0.0
    for (rd, _), (rh, _) in zip(batch, host):
        if (rd is None) != (rh is None):
            fail("ssx: the device and float64 searches disagree on which images index")
        if rd is not None:
            worst = max(worst, float(np.max(np.abs(np.subtract(rd.cell_parameters, rh.cell_parameters))
                                            / np.abs(rh.cell_parameters))))
    if worst > SSX_CELL_RTOL:
        fail(f"ssx: cells differ from the float64 search by {worst:.2e} relative")
    say(f"ssx: cells within {worst:.2e} relative of the float64 search (limit {SSX_CELL_RTOL})")
    if sum(ok_batch) < SSX_IMAGES // 2:
        fail(f"ssx: only {sum(ok_batch)}/{SSX_IMAGES} stills indexed")


def rotation_experiment(seed: int = 17, n_hkl: int = 250_000, phi_deg: float = 45.0,
                        osc: float = 0.1):
    """A seeded rotation sweep in tests/test_indexer_cli.py's recipe at
    Eiger 16M geometry: (experiment, true crystal, xyzobs.px.value)."""
    from ffs_tpu_torch.indexing.predict import predict_scan_static
    from ffs_tpu_torch.models.crystal import Crystal
    from ffs_tpu_torch.models.experiment import Experiment
    from ffs_tpu_torch.models.geometry import Goniometer, MonochromaticBeam, Scan, simple_panel

    rng = np.random.default_rng(seed)
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    crystal = Crystal(*(rot @ (length * np.eye(3)[k]) for k, length in enumerate(ROT_CELL)))
    beam, gonio = MonochromaticBeam(wavelength=1.0), Goniometer()
    scan = Scan(image_range=(1, int(round(phi_deg / osc))), oscillation=(0.0, osc))
    h, w = SIDE
    px = 0.075
    panel = simple_panel(distance_mm=200.0, beam_center_px=(w / 2, h / 2),
                         pixel_size_mm=(px, px), image_size=(w, h))
    hkl = rng.integers(-40, 41, size=(n_hkl, 3))
    hkl = np.unique(hkl[~(hkl == 0).all(axis=1)], axis=0)
    phi_seed = rng.uniform(0.0, np.deg2rad(phi_deg), size=len(hkl))
    kw = dict(s0=beam.s0, fixed_rotation=gonio.fixed_rotation,
              setting_rotation=gonio.setting_rotation, rotation_axis=gonio.rotation_axis,
              ub=crystal.a_matrix,
              d_matrix=np.stack([panel.fast_axis, panel.slow_axis, panel.origin], axis=1))
    pred = predict_scan_static(hkl, np.zeros(len(hkl), bool), phi_seed, **kw)
    s0_m2 = np.cross(beam.s0, gonio.setting_rotation @ gonio.rotation_axis)
    entering = (pred["s1"] @ (s0_m2 / np.linalg.norm(s0_m2))) < 0
    pred = predict_scan_static(hkl, entering, phi_seed, **kw)
    xyz = pred["xyzcal_mm"]
    phi = np.degrees(xyz[:, 2])
    ok = (pred["valid"] & (xyz[:, 0] > 1) & (xyz[:, 0] < w * px - 1) & (xyz[:, 1] > 1)
          & (xyz[:, 1] < h * px - 1) & (phi >= 0.0) & (phi < phi_deg))
    xyz = xyz[ok]
    xyzobs_px = np.stack([xyz[:, 0] / px, xyz[:, 1] / px,
                          np.degrees(xyz[:, 2]) / osc - 1 + scan.image_range[0]], axis=1)
    xyzobs_px += rng.normal(0.0, 0.1, xyzobs_px.shape)
    return Experiment(beam, panel, gonio, scan), crystal, xyzobs_px


def phase_rotation(dev, card: str) -> None:
    """Phase 14: the rotation indexer's core on a seeded Eiger 16M sweep; the
    256^3 complex128 FFT on the card against NumPy's."""
    import torch

    from ffs_tpu_torch.indexing import fft3d
    from ffs_tpu_torch.indexing.rlp import xyz_to_rlp
    from ffs_tpu_torch.pipeline.indexer import IndexOptions, index_experiment, indexed_reflections

    expt, truth, xyzobs_px = rotation_experiment()
    n = len(xyzobs_px)
    if n < ROT_MIN_REFLECTIONS:
        fail(f"rotation: only {n} strong reflections (need {ROT_MIN_REFLECTIONS})")
    options = IndexOptions(max_cell=100.0)

    rlp = xyz_to_rlp(xyzobs_px, expt.panel, expt.beam, expt.scan, expt.goniometer)["rlp"]
    d_min = max(5.0 * options.max_cell / 256, float((1.0 / np.linalg.norm(rlp, axis=1)).min()))
    grid, _ = fft3d.map_centroids_to_grid(rlp, d_min, fft3d.b_iso_from_d_min(d_min), 256)
    torch.cuda.reset_peak_memory_stats(dev)
    g = torch.from_numpy(grid).to(dev)
    fft_ms = cuda_ms(lambda: fft3d.fft_power(g), reps=5)
    got = fft3d.fft_power(g).cpu().numpy()
    peak_mb = torch.cuda.max_memory_allocated(dev) / 1e6
    t0 = time.perf_counter()
    want = np.square(np.real(np.fft.fftn(grid)))
    np_ms = 1e3 * (time.perf_counter() - t0)
    err = float(np.max(np.abs(got - want)) / want.max())
    if not np.allclose(got, want, rtol=1e-12, atol=1e-12 * want.max()):
        fail(f"rotation: the card's FFT differs from NumPy's ({err:.2e} of the peak)")
    say(f"fft3d n = 256 complex128: {fft_ms:.2f} ms on {card} (peak {peak_mb:.0f} MB) against "
        f"NumPy's {np_ms:.0f} ms on the host; max |difference| {err:.1e} of the peak")
    del g

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        outcome = index_experiment(expt, xyzobs_px, options, device=dev)
        t_index = time.perf_counter() - t0
        cols = indexed_reflections(outcome.expt, xyzobs_px) if outcome else None
    if outcome is None:
        fail("rotation: the indexer found no crystal:\n" + buf.getvalue()[-2000:])
    cell = np.asarray(outcome.expt.crystal.unit_cell)
    rel = np.abs(np.sort(cell[:3]) - np.sort(ROT_CELL)) / np.sort(ROT_CELL)
    if rel.max() > 0.01 or np.abs(cell[3:] - 90.0).max() > 1.0:
        fail(f"rotation: recovered cell {cell.round(3).tolist()}, truth {ROT_CELL}")
    if cols["n_indexed"] < 0.8 * n:
        fail(f"rotation: indexed {cols['n_indexed']}/{n}")
    say(f"rotation: {n} strong reflections, {len(outcome.vectors)} candidate vectors, "
        f"{len(outcome.candidates)} scored crystals; cell "
        + " ".join(f"{v:.3f}" for v in cell) + f" (within {rel.max():.1e} of the truth); "
        f"indexed {cols['n_indexed']}/{n}")
    say(f"rotation index (FFT on the card, scoring and refinement on the host): "
        f"{t_index:.2f} s on {card}")


def phase_pia_hook(dev, card: str) -> None:
    """Phase 15: the spotfinder's pipe lines (``--output-for-index``) through
    the PIA's per-line indexing step with an armed indexer."""
    from ffs_tpu_torch.indexing.ssx import SSXIndexer
    from ffs_tpu_torch.io import sample_data
    from ffs_tpu_torch.models.geometry import simple_panel
    from ffs_tpu_torch.service.pipe_index import index_pipe_payload

    rc, log, lines, _ = run_cli(["--sample", "--output-for-index", "--min-spot-size", "1",
                                 "--wavelength", str(PIA_WAVELENGTH)])
    if rc != 0 or len(lines) != sample_data.NUM_SAMPLE_IMAGES:
        fail(f"pia hook: spotfinder rc={rc}, {len(lines)} pipe lines\n{log[-2000:]}")
    h, w = SIDE
    indexer = SSXIndexer(device=dev)
    indexer.cell = PIA_CELL
    indexer.panel = simple_panel(distance_mm=500.0, beam_center_px=(w / 2, h / 2),
                                 pixel_size_mm=(0.075, 0.075), image_size=(w, h),
                                 mu=PIA_MU_SI, thickness=0.45, parallax=True, material="Si")
    indexer.wavelength = PIA_WAVELENGTH
    for line in lines:
        n_spots = len(line.get("spot_centers", ())) // 3
        t0 = time.perf_counter()
        data = index_pipe_payload(indexer, dict(line))
        dt = time.perf_counter() - t0
        if "spot_centers" in data or "lattices" not in data or "n_unindexed" not in data:
            fail(f"pia hook: line {line['file-number']} came back with keys {sorted(data)}")
        n_idx = sum(lat["n_indexed"] for lat in data["lattices"])
        if n_idx + data["n_unindexed"] != n_spots:
            fail(f"pia hook: line {line['file-number']}: {n_idx} indexed + "
                 f"{data['n_unindexed']} unindexed != {n_spots} spots")
        say(f"pia hook image {line['file-number']}: {n_spots} spots, "
            f"{len(data['lattices'])} lattice(s), {data['n_unindexed']} unindexed, "
            f"{1e3 * dt:.1f} ms on {card}")


# phase 16: the integrator's --bg-device path.  (a) phase 7's collection
# through integrate_experiment(bg_device=True), both background models,
# against the host path; (b) the whole sweep that phase 7 cuts to 40 images
# (~1.63M predictions): device bounding boxes, backgrounds and finalisation
# at that N, the host functions on its first HOST_ROWS rows (the host GLM
# on its first GLM_HOST_ROWS: over every row it would take minutes); (c)
# baseline_predictor_torch on a PREDICTOR_IMAGES-image scan of the sweep's
# configuration
SWEEP_IMAGES = 3600
HOST_ROWS = 65536
# the host GLM reference, ~1.7 ms a row, runs on the first GLM_HOST_ROWS:
# the edge rows and the Poisson rows after them (rows are independent)
GLM_HOST_ROWS = 4096
# phase 16c: the predictor CLI on a scan of the sweep's configuration
PREDICTOR_IMAGES = 360
# the JAX package's own tolerances: its device background against NumPy
# (tests/test_integrator_cli.py), its device finalisation against NumPy
# (tests/test_integration.py)
BG_TOL = dict(rtol=1e-12, atol=1e-12)
FIN_TOL = dict(rtol=1e-12, atol=1e-14)
FIN_FIELDS = ("intensity", "variance", "background_mean", "background_sum", "xyzobs_px",
              "partiality", "lp", "d")


def timed(fn):
    """(fn(), seconds) on the host clock, the device synchronised on both
    sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def differ(got: dict, want: dict, tol: dict) -> list[str]:
    """Names of the entries of ``want`` that ``got`` does not match: floats
    within ``tol``, everything else exactly, dtypes and shapes equal."""
    bad = []
    for name, b in want.items():
        a, b = np.asarray(got[name]), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            bad.append(f"{name} ({a.dtype}{a.shape} against {b.dtype}{b.shape})")
        elif np.issubdtype(b.dtype, np.floating):
            if not np.allclose(a, b, equal_nan=True, **tol):
                rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
                bad.append(f"{name} (max relative difference {np.nanmax(rel):.2e})")
        elif not np.array_equal(a, b):
            bad.append(f"{name} ({int((a != b).sum())} entries differ)")
    return bad


def bbox_mismatch(label: str, got: np.ndarray, want: np.ndarray, inputs) -> None:
    """Fails, with the rows' inputs and extents, where two bounding-box
    arrays differ."""
    rows = np.flatnonzero((got != want).any(axis=1))
    if len(rows):
        s1, phi = inputs
        detail = "; ".join(f"row {r}: s1 {s1[r].tolist()} phi {phi[r]!r} device "
                           f"{got[r].tolist()} host {want[r].tolist()}" for r in rows[:3])
        fail(f"{label}: {len(rows)} of {len(want)} device bounding boxes differ from the "
             f"host's: {detail}")


def phase_bg_device(dev, card: str, col, acc7) -> None:
    """Phase 16 (a): ``integrate_experiment`` on phase 7's collection, host
    and device path for both background models: device boxes bit-equal to
    the host's, accumulators bit-equal to phase 7's, every column within the
    JAX package's finalisation tolerance (integers exactly), the same valid
    and rejected counts, and the gathers launched as the run's chunks say."""
    import torch

    from ffs_tpu_torch.integration import extent
    from ffs_tpu_torch.ops import window_gather as wg
    from ffs_tpu_torch.pipeline.integrator import integrate_experiment

    expt, pred = col.expt, col.pred
    sigma_b, sigma_m = np.deg2rad(SIGMA_B_DEG), np.deg2rad(SIGMA_M_DEG)
    phi = pred.xyzcal_mm[:, 2]
    args = (expt.beam.s0, expt.goniometer.rotation_axis, pred.s1, phi, sigma_b, sigma_m,
            expt.panel, expt.scan)
    bbox_mismatch("bg-device", extent.compute_kabsch_bounding_boxes_device(*args, device=dev),
                  extent.compute_kabsch_bounding_boxes(*args), (pred.s1, phi))
    say(f"bg-device: the device bounding boxes of {len(phi)} predictions equal the host's "
        f"bit for bit")

    reader = HostFrames(col.frames, col.mask)
    for background in ("constant", "glm"):
        runs = {}
        for bg_device in (False, True):
            stage_t: dict[str, float] = {}
            t_last = time.perf_counter()

            def mark(stage: str) -> None:
                nonlocal t_last
                torch.cuda.synchronize()
                now = time.perf_counter()
                stage_t[stage] = stage_t.get(stage, 0.0) + (now - t_last)
                t_last = now

            buf = io.StringIO()
            wg.window_gather_planes.launches = 0
            wg.window_gather.launches = 0
            with contextlib.redirect_stdout(buf):
                out = integrate_experiment(
                    expt, {}, reader, device=dev, sigma_b=sigma_b, sigma_m=sigma_m,
                    background=background, bg_device=bg_device, mark=mark,
                )
            mark("finalize")
            launches = {"window_gather_planes": wg.window_gather_planes.launches,
                        "window_gather": wg.window_gather.launches}
            integ = out.integrator
            want = {"window_gather_planes": integ.chunk_setups + integ.block_steps,
                    "window_gather": integ.chunk_setups}
            tag = f"{background}, {'device' if bg_device else 'host'}"
            if launches != want or min(launches.values()) == 0:
                fail(f"bg-device ({tag}): gather launches {launches}, expected {want}")
            for name in ACC_FIELDS:
                if not np.array_equal(getattr(out.acc, name), getattr(acc7, name)):
                    fail(f"bg-device ({tag}): accumulator {name} differs from phase 7's")
            summary = [line for line in buf.getvalue().splitlines()
                       if line.startswith(("Summation", "Background estimate", "note:"))]
            runs[bg_device] = out, stage_t, summary, launches
        (host, host_t, host_sum, _), (devo, dev_t, dev_sum, launches) = runs[False], runs[True]
        if not np.array_equal(devo.integrator.bboxes, host.integrator.bboxes):
            fail(f"bg-device ({background}): the integrator's boxes differ between the paths")
        bad = differ(devo.columns, host.columns, FIN_TOL)
        if bad:
            fail(f"bg-device ({background}): columns differ from the host path's: {bad}")
        if dev_sum != host_sum:
            fail(f"bg-device ({background}): device path says {dev_sum}, host path {host_sum}")
        say(f"bg-device {background}: accumulators equal phase 7's bit for bit, every column "
            f"within rtol 1e-12 of the host path (integers exactly); {'; '.join(dev_sum)}; "
            f"gather launches {launches}")
        say(f"bg-device {background} stage ms on {card}: "
            + ", ".join(f"{stage} host {1e3 * host_t[stage]:.1f} / device "
                        f"{1e3 * dev_t[stage]:.1f}"
                        for stage in ("bbox+setup", "background", "finalize")))


def seeded_histograms(n: int, dev, seed: int = 11):
    """Background histograms of ``n`` reflections made on the card: each row
    100-1000 Poisson pixels of a mean in [0.5, 40.5), values of 256 and up
    in the overflow count.  The first rows are the edge cases, by label."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lam = torch.rand(n, generator=gen, device=dev, dtype=torch.float32) * 40.0 + 0.5
    npx = torch.randint(100, 1001, (n,), generator=gen, device=dev)
    cols = torch.arange(1000, device=dev)
    counts = torch.empty((n, 257), dtype=torch.int64, device=dev)
    block = 65536
    for r0 in range(0, n, block):
        m = min(n, r0 + block) - r0
        v = torch.poisson(lam[r0 : r0 + m, None].expand(m, 1000).contiguous(), gen)
        idx = v.clamp_(max=256).long() + torch.arange(m, device=dev)[:, None] * 257
        idx = idx[cols[None, :] < npx[r0 : r0 + m, None]]
        counts[r0 : r0 + m] = torch.bincount(idx, minlength=m * 257).view(m, 257)
    edges = []

    def edge(label, row, over=0):
        edges.append((label, row, over))

    rng = np.random.default_rng(seed)
    for _ in range(4):
        v = rng.poisson(300.0, 400)
        edge("overflow > 25%", np.bincount(v[v < 256], minlength=256), int((v >= 256).sum()))
    for k in (5, 9):
        edge("< 10 pixels", np.bincount(rng.poisson(4.0, k), minlength=256))
    edge("empty", np.zeros(256, np.int64))
    edge("empty", np.zeros(256, np.int64))
    for hits in (((2, 2001), (40, 2000)), ((0, 300), (2, 1), (255, 300))):
        row = np.zeros(256, np.int64)
        for value, count in hits:
            row[value] = count
        edge("GLM_MAX_ITER", row)
    row = np.zeros(256, np.int64)
    row[0] = 500
    edge("all zero", row)
    for k, (_, row, over) in enumerate(edges):
        counts[k, :256] = torch.as_tensor(row, device=dev)
        counts[k, 256] = over
    return counts[:, :256].contiguous(), counts[:, 256].contiguous(), [e[0] for e in edges]


def phase_bg_device_sweep(dev, card: str, slices_per_s: float):
    """Phase 16 (b): the device stages of ``--bg-device`` at collection
    scale."""
    import types

    import torch

    from ffs_tpu_torch.integration import background as bg_host
    from ffs_tpu_torch.integration import extent
    from ffs_tpu_torch.integration import finalize as fin
    from ffs_tpu_torch.integration.background_device import estimate_background_device
    from ffs_tpu_torch.prediction.rotation import predict_rotation

    expt = eiger_experiment(n_images=SWEEP_IMAGES)
    pred, t_pred = timed(lambda: predict_rotation(expt, device=dev))
    n = len(pred.hkl)
    say(f"sweep: {SWEEP_IMAGES} images, {n} predictions ({n / SWEEP_IMAGES:.0f} per image) "
        f"from predict_rotation in {t_pred:.1f} s on {card}")
    if n < 1_500_000:
        fail(f"sweep: only {n} predictions")
    k = HOST_ROWS
    sigma_b, sigma_m = np.deg2rad(SIGMA_B_DEG), np.deg2rad(SIGMA_M_DEG)
    phi = pred.xyzcal_mm[:, 2]

    def bbox_args(rows):
        return (expt.beam.s0, expt.goniometer.rotation_axis, pred.s1[rows], phi[rows],
                sigma_b, sigma_m, expt.panel, expt.scan)

    extent.compute_kabsch_bounding_boxes_device(*bbox_args(slice(0, 1024)), device=dev)
    bb_dev, t_bb_dev = timed(
        lambda: extent.compute_kabsch_bounding_boxes_device(*bbox_args(slice(None)), device=dev))
    bb_host, t_bb_host = timed(lambda: extent.compute_kabsch_bounding_boxes(*bbox_args(slice(None))))
    bbox_mismatch("sweep", bb_dev, bb_host, (pred.s1, phi))

    # the integrator's steps after the boxes: min_zeta, the clip to the panel
    axis = expt.goniometer.rotation_axis
    zeta = extent.coordinate_systems(expt.beam.s0, axis / np.linalg.norm(axis), pred.s1).zeta
    bboxes = bb_dev.copy()
    w, h = expt.panel.image_size
    for j, lim in ((0, w - 1), (1, w - 1), (2, h - 1), (3, h - 1)):
        bboxes[:, j] = np.clip(bboxes[:, j], 0, lim)
    depth = np.clip(bboxes[:, 5], 0, SWEEP_IMAGES) - np.clip(bboxes[:, 4], 0, SWEEP_IMAGES)
    slices = int(np.maximum(depth, 0)[np.abs(zeta) >= 0.05].sum())
    say(f"sweep bounding boxes: device {1e3 * t_bb_dev:.1f} ms ({n / t_bb_dev:.3e} "
        f"reflections/s), host {1e3 * t_bb_host:.1f} ms ({n / t_bb_host:.3e} reflections/s) on "
        f"{card}; equal bit for bit on all {n} rows; {slices} reflection-image slices")

    # the device boxes' time split: the upload of s1 and phi, the call on
    # inputs already on the card, and in that call the download of the
    # (N, 6) float64 extents and their int64 cast on the host; the rest of
    # the resident call is the card's arithmetic and its dispatch
    (s1_d, phi_d), t_bb_up = timed(
        lambda: (torch.as_tensor(pred.s1).to(dev, torch.float64),
                 torch.as_tensor(phi).to(dev, torch.float64)))
    bb_res, t_bb_res = timed(lambda: extent.compute_kabsch_bounding_boxes_device(
        expt.beam.s0, expt.goniometer.rotation_axis, s1_d, phi_d, sigma_b, sigma_m, expt.panel,
        expt.scan))
    bbox_mismatch("sweep, resident inputs", bb_res, bb_host, (pred.s1, phi))
    del s1_d, phi_d
    ext_d = torch.zeros((n, 6), dtype=torch.float64, device=dev)
    ext_h, t_bb_down = timed(lambda: ext_d.cpu().numpy())
    _, t_bb_cast = timed(lambda: ext_h.astype(np.int64))
    del ext_d, ext_h
    say(f"sweep bounding-box split on {card}: upload of s1 and phi {1e3 * t_bb_up:.1f} ms; the "
        f"call on inputs on the card {1e3 * t_bb_res:.1f} ms (equal bit for bit), of which the "
        f"download of the extents {1e3 * t_bb_down:.1f} ms and their host cast "
        f"{1e3 * t_bb_cast:.1f} ms, leaving {1e3 * (t_bb_res - t_bb_down - t_bb_cast):.1f} ms "
        f"of arithmetic and dispatch")

    (hist, over, labels), t_hist = timed(lambda: seeded_histograms(n, dev))
    hist_host, over_host = hist.cpu().numpy(), over.cpu().numpy()
    say(f"sweep histograms: {n} x 256 made on the card in {t_hist:.2f} s; "
        f"{int(hist_host.sum() + over_host.sum())} background pixels; edge rows {labels}")

    t_dev = {"bbox": t_bb_dev}
    bg = {}
    for model, name in (("tukey", "constant"), ("glm", "glm")):
        estimate_background_device(hist_host[:1024], over_host[:1024], model, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        got, t_from_host = timed(
            lambda: estimate_background_device(hist_host, over_host, model, device=dev))
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        _, t_resident = timed(lambda: estimate_background_device(hist, over, model))
        k_ref = HOST_ROWS if model == "tukey" else GLM_HOST_ROWS
        want, t_host = timed(lambda: bg_host.estimate_background(
            hist_host[:k_ref], over_host[:k_ref], model))
        got_k = [v[:k_ref].cpu().numpy() for v in got]
        if not np.array_equal(got_k[2], want[2]):
            rows = np.flatnonzero(got_k[2] != want[2])
            fail(f"sweep {name} background: valid differs on {len(rows)} rows, first {rows[:5]}")
        bad = differ({"mean": got_k[0], "wsum": got_k[1]}, {"mean": want[0], "wsum": want[1]},
                     BG_TOL)
        if bad:
            fail(f"sweep {name} background: {bad} beyond 1e-12 of the host")
        valid = got_k[2]
        expect_invalid = {"overflow > 25%", "empty"} | (
            {"< 10 pixels", "GLM_MAX_ITER"} if model == "glm" else set())
        for row, label in enumerate(labels):
            if label in expect_invalid and valid[row]:
                fail(f"sweep {name} background: the '{label}' row {row} came out valid")
        t_dev[name] = t_from_host
        bg[name] = got
        say(f"sweep {name} background on {card}: device {1e3 * t_from_host:.1f} ms from host "
            f"arrays ({n / t_from_host:.3e} reflections/s; {1e3 * t_resident:.1f} ms on inputs "
            f"already on the card; peak {peak_gb:.1f} GB), host {1e3 * t_host:.1f} ms at {k_ref} "
            f"rows ({k_ref / t_host:.3e} reflections/s); first {k_ref} rows within 1e-12, valid exact "
            f"({int(valid.sum())} valid)")

    rng = np.random.default_rng(13)
    fg_count = rng.integers(0, 120, n)
    fg_count[rng.random(n) < 0.02] = 0
    fg_sum = rng.poisson(500.0, n).astype(np.float64) * (fg_count > 0)
    acc = types.SimpleNamespace(
        fg_sum=fg_sum, fg_count=fg_count, bg_count=hist_host.sum(axis=1) + over_host,
        sum_ix=fg_sum * pred.xyzcal_px[:, 0], sum_iy=fg_sum * pred.xyzcal_px[:, 1],
        sum_iz=fg_sum * pred.xyzcal_px[:, 2])
    kw = dict(bboxes=bboxes, s1=pred.s1, phi=phi, hkl=pred.hkl, zeta=zeta, scan=expt.scan,
              beam=expt.beam, gonio=expt.goniometer, crystal=expt.crystal, sigma_m=sigma_m)
    mean_d, wsum_d, valid_d = bg["glm"]

    def first(rows):
        """The finalisation's row-wise inputs cut to their first ``rows``."""
        return types.SimpleNamespace(**{f: v[:rows] for f, v in vars(acc).items()}), {
            key: v[:rows] if isinstance(v, np.ndarray) and len(v) == n else v
            for key, v in kw.items()}

    acc_w, kw_w = first(1024)
    fin.finalize_device(acc=acc_w, bg_mean=mean_d[:1024], bg_wsum=wsum_d[:1024],
                        bg_valid=valid_d[:1024], device=dev, **kw_w)
    got, t_fin = timed(lambda: fin.finalize_device(acc=acc, bg_mean=mean_d, bg_wsum=wsum_d,
                                                   bg_valid=valid_d, device=dev, **kw))
    # the host finalisation on the same background (the device's, which
    # the check above holds to the host's): an intensity is a difference
    # that 1e-12 in a background mean can move far more than 1e-12
    acc_k, kw_k = first(k)
    bg_k = [v[:k].cpu().numpy() for v in (mean_d, wsum_d, valid_d)]
    want, t_fin_host = timed(lambda: fin.finalize(acc=acc_k, bg_mean=bg_k[0], bg_wsum=bg_k[1],
                                                  bg_valid=bg_k[2], **kw_k))
    bad = differ({f: getattr(got, f)[:k] for f in FIN_FIELDS + ("valid",)},
                 {f: getattr(want, f) for f in FIN_FIELDS + ("valid",)}, FIN_TOL)
    n_fail_k = int(((fg_count[:k] > 0) & ~bg_k[2]).sum())
    if bad or n_fail_k != want.n_background_failures:
        fail(f"sweep finalize: {bad}; host rejected {want.n_background_failures}, "
             f"expected {n_fail_k}")
    t_dev["finalize"] = t_fin

    # the finalisation's time split, as the boxes' above: the upload of its
    # row inputs as finalize_device converts them, the call on inputs on the
    # card, and the download of its output columns alone
    names = ("fg_sum", "fg_count", "bg_count", "sum_ix", "sum_iy", "sum_iz")
    rows_in = [getattr(acc, f) for f in names] + [kw[f] for f in ("bboxes", "s1", "phi", "hkl",
                                                                  "zeta")]
    res, t_fin_up = timed(lambda: [torch.as_tensor(a).to(dev, torch.float64) for a in rows_in])
    acc_res = types.SimpleNamespace(**dict(zip(names, res[:6])))
    kw_res = dict(kw, **dict(zip(("bboxes", "s1", "phi", "hkl", "zeta"), res[6:])))
    got_res, t_fin_res = timed(lambda: fin.finalize_device(
        acc=acc_res, bg_mean=mean_d, bg_wsum=wsum_d, bg_valid=valid_d, device=dev, **kw_res))
    bad = differ({f: getattr(got_res, f) for f in FIN_FIELDS + ("valid",)},
                 {f: getattr(got, f) for f in FIN_FIELDS + ("valid",)}, {"rtol": 0, "atol": 0})
    if bad:
        fail(f"sweep finalize on inputs on the card: {bad} differ from the call on host arrays")
    del res, acc_res, kw_res, got_res
    outs = [torch.zeros(n, dtype=torch.float64, device=dev) for _ in range(7)] + [
        torch.zeros((n, 3), dtype=torch.float64, device=dev),
        torch.zeros(n, dtype=torch.bool, device=dev)]
    _, t_fin_down = timed(lambda: [v.cpu().numpy() for v in outs])
    del outs
    say(f"sweep finalize split on {card}: upload of the row inputs {1e3 * t_fin_up:.1f} ms; the "
        f"call on inputs on the card {1e3 * t_fin_res:.1f} ms (equal bit for bit), of which the "
        f"download of the columns {1e3 * t_fin_down:.1f} ms, leaving "
        f"{1e3 * (t_fin_res - t_fin_down):.1f} ms of arithmetic and dispatch")
    say(f"sweep finalize on {card}: device {1e3 * t_fin:.1f} ms at {n} rows "
        f"({n / t_fin:.3e} reflections/s; {got.n_background_failures} backgrounds rejected), "
        f"host {1e3 * t_fin_host:.1f} ms at {k} rows ({k / t_fin_host:.3e} reflections/s); "
        f"first {k} rows within rtol 1e-12, valid exact")

    est = slices / slices_per_s
    device_s = t_dev["bbox"] + t_dev["glm"] + t_dev["finalize"]
    say(f"sweep: device stages (boxes, GLM background from host arrays, finalize) {device_s:.3f} s "
        f"against an estimated {est:.1f} s of integrate() for {slices} slices at phase 7's "
        f"{slices_per_s:.0f} slices/s: {100 * device_s / est:.2f}% on {card}")


def phase_predictor_cli(dev, card: str) -> None:
    """Phase 16 (c): ``baseline_predictor_torch`` (``predictor.run``) on a
    PREDICTOR_IMAGES-image scan of the sweep's configuration; its table
    must equal ``predict_rotation``'s rows on the same card exactly."""
    from ffs_tpu_torch.models.reflection_table import ReflectionTable
    from ffs_tpu_torch.pipeline import predictor
    from ffs_tpu_torch.prediction.rotation import predict_rotation

    expt = eiger_experiment(n_images=PREDICTOR_IMAGES)
    pred, t_pred = timed(lambda: predict_rotation(expt, device=dev))

    try:
        import h5py  # noqa: F401

        held = None
    except ImportError:  # without h5py, hold the table run() would write
        held = {}
    saved = ReflectionTable.write
    with tempfile.TemporaryDirectory() as tmp:
        path, out = os.path.join(tmp, "sweep.expt"), os.path.join(tmp, "predicted.refl")
        with open(path, "w") as f:
            json.dump(expt.to_json_obj(), f)
        if held is not None:
            ReflectionTable.write = lambda self, p, *a, **kw: held.__setitem__(p, self)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc, seconds = timed(lambda: predictor.run(["-e", path, "--output", out]))
        finally:
            ReflectionTable.write = saved
        table = held[out] if held is not None else ReflectionTable.read(out)
    log = buf.getvalue()
    count = f"Predicted {len(pred.hkl)} reflections"
    if rc != 0 or count not in log:
        fail(f"predictor: rc={rc}, log {log[-500:]!r}")
    want = {"miller_index": pred.hkl.astype(np.int32), "panel": pred.panel,
            "entering": pred.entering.astype(np.uint8), "s1": pred.s1,
            "xyzcal.px": pred.xyzcal_px, "xyzcal.mm": pred.xyzcal_mm, "flags": pred.flags,
            "id": np.zeros(len(pred.hkl), np.int64)}
    bad = differ({name: table[name] for name in want}, want, dict(rtol=0.0, atol=0.0))
    if bad or table.identifiers != [expt.identifier]:
        fail(f"predictor: predicted.refl differs from predict_rotation: {bad}, identifiers "
             f"{table.identifiers}")
    where = "held in memory: no h5py on this machine" if held is not None else "written and read back"
    say(f"baseline_predictor_torch on {PREDICTOR_IMAGES} images: {count.lower()} in "
        f"{seconds:.1f} s (predict_rotation {t_pred:.1f} s) on {card}; predicted.refl ({where}) "
        f"equals predict_rotation exactly")


# phase 17: multi-device.  (a) DP: the stage tool's B = 8 Eiger 16M batch
# (seed 12) as frames and as bitshuffle planes from the port's codec; (b) SP:
# one seeded Jungfrau 4M frame, 2164 x 2068 (541 rows a rank at 4; Eiger
# 16M's 4362 rows do not divide by 4), spots across every shard boundary at
# 2 and 4 ranks; (c) the first chunk of phase 7's collection (A = 2048,
# F = 4); (d) the DP batch as a rotation chunk, a spot across every frame
# pair that can straddle a rank boundary.  NCCL with one rank a card on 2-4
# cards; on one card, 2 ranks share cuda:0 over gloo
MULTI_MAX_WORLD = 4
JF4M = 2164, 2068
MULTI_KF = 8192  # slots a frame: a batch frame holds ~3,000 strong pixels
SP_CHIP_PX = 65536  # slots a row shard of the Jungfrau 4M frame
SP_SPOTS = 8192
HALO_REPS = 20  # halo exchanges a timing
MULTI_KERNELS = ("dispersion_packed", "dispersion_extended_packed", "window_gather_planes",
                 "window_gather", "bitshuffle_frames")


def multi_kernel_wrappers():
    """Kernel name -> its wrapper, for the kernels phase 17's path runs."""
    from ffs_tpu_torch.ops import bitshuffle_device as bd
    from ffs_tpu_torch.ops import dispersion_extended_packed as dxp
    from ffs_tpu_torch.ops import dispersion_packed as dp
    from ffs_tpu_torch.ops import window_gather as wg

    return dict(zip(MULTI_KERNELS, (dp.dispersion_packed_raw, dxp.dispersion_extended_packed_raw,
                                    wg.window_gather_planes, wg.window_gather,
                                    bd.frames_from_planes)))


def jungfrau_4m_frame() -> np.ndarray:
    """A seeded 2164 x 2068 u16 frame: Poisson(4), 400 scattered 3x3 spots
    and, across every row shard boundary at 2 and 4 ranks (rows 541, 1082,
    1623), 5x5 spots every 97 columns and a 2-column streak over 60 rows.
    Every spot's total stays far below 2^24 / 2164, so its float32
    weighted sums are exact integers and the table is order-independent."""
    h, w = JF4M
    rng = np.random.default_rng(41)
    frame = rng.poisson(4.0, size=(h, w)).astype(np.uint16)
    for y, x in zip(rng.integers(4, h - 4, 400), rng.integers(4, w - 4, 400)):
        frame[y - 1 : y + 2, x - 1 : x + 2] += rng.poisson(60, size=(3, 3)).astype(np.uint16)
    for b in (541, 1082, 1623):
        for x in range(11, w - 11, 97):
            frame[b - 3 : b + 2, x - 2 : x + 3] += rng.poisson(50, size=(5, 5)).astype(np.uint16)
        frame[b - 30 : b + 30, 40 + b // 10 : 42 + b // 10] += np.uint16(40)
    return frame


ROT_PAIRS = (2, 4, 6)  # first frame after each boundary that 2 or 4 ranks can draw


def rotation_batch(batch: np.ndarray) -> tuple[np.ndarray, list]:
    """The DP batch with a 4x4 Poisson(80) spot on frames b-1, b, b+1 for
    each b of ROT_PAIRS, each at its own place; returns (frames, centres)."""
    rng = np.random.default_rng(43)
    rot = batch.copy()
    centres = []
    for i, b in enumerate(ROT_PAIRS):
        y, x = 1000 + 700 * i, 1200 + 500 * i
        for f in (b - 1, b, b + 1):
            rot[f, y : y + 4, x : x + 4] += rng.poisson(80, size=(4, 4)).astype(np.uint16)
        centres.append((b, y, x))
    return rot, centres


def kabsch_chunk(integ, frames_host: np.ndarray) -> dict:
    """The first chunk of an integrator's run and its first four-frame block:
    the chunk's reflection indices, its coordinate-system arrays and the
    block's host frames and per-frame arguments, as ``integrate`` makes
    them."""
    order = np.argsort(integ.bboxes[:, 4], kind="stable")
    cs_e1 = np.cross(integ.s1, integ._s0)
    cs_e1 /= np.linalg.norm(cs_e1, axis=1, keepdims=True)
    cs_e2 = np.cross(integ.s1, cs_e1)
    cs_e2 /= np.linalg.norm(cs_e2, axis=1, keepdims=True)
    osc_start, osc_width = integ.scan.oscillation
    f = integ.frame_block
    blk = np.arange(f, dtype=np.float64)  # images 0..F-1 (z0 - 1 = 0)
    return dict(
        chunk=order[: integ.max_active], cs_e1=cs_e1, cs_e2=cs_e2, zeta=cs_e1 @ integ._m2,
        frames=frames_host[:f], phi_lows=np.deg2rad(osc_start + blk * osc_width),
        d_osc=float(np.deg2rad(osc_width)), z_values=blk, frame_ok=np.ones(f, dtype=bool),
    )


def integrator_args(expt, integ) -> dict:
    """What a rank needs to rebuild ``integ`` (made for ``expt``) on its
    own card."""
    return dict(panel=expt.panel, beam=expt.beam, gonio=expt.goniometer, scan=expt.scan,
                s1=integ.s1, phi=integ.phi, bboxes=integ.bboxes, delta_b=integ._delta_b,
                delta_m=integ._delta_m, algorithm=integ.algorithm,
                max_active=integ.max_active, frame_block=integ.frame_block)


def multi_rank(backend: str, store: str, kabsch: dict, integ_kw: dict) -> dict:
    """One rank of phase 17 (a ``run_ranks`` target): every mesh function on
    the phase's host arrays (loaded from ``store``; each rank uploads only
    its shard), with this rank's kernel launches (counts set to 0 just
    before) and host-clock ms between barriers.  Each part runs twice: the
    first call gives the result, the second the time (the first pays the
    card's lazy module loads and NCCL's peer connections)."""
    import torch

    from ffs_tpu_torch.integration.kabsch import KabschIntegrator
    from ffs_tpu_torch.parallel import mesh as pm
    from ffs_tpu_torch.utils import torchinit

    torchinit.setup()
    mesh = pm.make_mesh(backend=backend)
    a = {name: np.load(os.path.join(store, name + ".npy"))
         for name in ("frames", "planes", "mask", "sp", "rot", "kframes", "kmask")}
    zero = torch.zeros((), dtype=torch.int64, device=mesh.device)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    def clocked(fn):
        res = fn()
        pm.all_reduce(zero, mesh)  # a barrier
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        pm.all_reduce(zero, mesh)
        return res, 1e3 * (time.perf_counter() - t0)

    wrappers = multi_kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    out, ms = {}, {}
    kw = dict(max_pixels_per_frame=MULTI_KF, max_spots_per_chip=MULTI_KF)
    # (a) DP
    out["counts"], ms["counts"] = clocked(lambda: pm.sharded_spotfind_counts(
        mesh, a["frames"], a["mask"], 65535.0))
    out["packed"], ms["packed"] = clocked(lambda: pm.sharded_packed_pipeline(
        mesh, a["frames"], a["mask"], 65535.0, **kw))
    out["planes"], ms["planes"] = clocked(lambda: pm.sharded_packed_pipeline_planes(
        mesh, a["planes"], a["frames"].shape[1:], np.uint16, a["mask"], 65535.0, **kw))
    # (b) SP
    sp_mask = np.ones(a["sp"].shape, np.uint8)
    out["halo"], ms["halo"] = clocked(lambda: pm.halo_sharded_dispersion(
        mesh, a["sp"], sp_mask, 65535.0))
    for key, extended in (("sp", False), ("ext", True)):
        out[key], ms[key] = clocked(lambda: pm.sharded_packed_sp_pipeline(
            mesh, a["sp"], sp_mask, 65535.0, max_pixels_per_chip=SP_CHIP_PX,
            max_spots=SP_SPOTS, extended=extended))
        out[key + "_rounds"] = pm.sharded_packed_sp_pipeline.merge_rounds
    hs = a["sp"].shape[0] // mesh.size
    strip = torch.from_numpy(a["sp"][mesh.rank * hs : (mesh.rank + 1) * hs]).to(mesh.device)
    _, t = clocked(lambda: [pm._halo_exchange(strip, 11, mesh) for _ in range(HALO_REPS)])
    ms["halo_exchange"] = t / HALO_REPS
    # (c) the Kabsch block step, each rank setting up its own rows of the chunk
    integ = KabschIntegrator(device=mesh.device, **integ_kw)
    integ.set_mask(a["kmask"])
    frames = integ.pad_frames(torch.from_numpy(a["kframes"]).to(mesh.device))
    chunk, ms["kabsch_setup"] = clocked(lambda: pm.sharded_chunk_setup(
        mesh, integ, kabsch["chunk"], kabsch["cs_e1"], kabsch["cs_e2"], kabsch["zeta"]))
    out["kabsch"], ms["kabsch"] = clocked(lambda: pm.sharded_kabsch_block_step(
        mesh, integ, frames, chunk, kabsch["phi_lows"], kabsch["d_osc"], kabsch["z_values"],
        kabsch["frame_ok"], local=True))
    # (d) the rotation chunk
    out["rotation"], ms["rotation"] = clocked(lambda: pm.sharded_rotation_compact(
        mesh, a["rot"], a["mask"], 65535.0, max_pixels_per_frame=MULTI_KF))
    sync()
    out["launches"] = {name: fn.launches for name, fn in wrappers.items()}
    out["ms"] = ms
    out["device"] = str(mesh.device)
    return out


def single_packed(frames, mask, world: int, dev):
    """The packed DP pipeline's outputs on one device: per-frame counts of
    the whole batch, spots of each rank's frames, the total."""
    import torch

    from ffs_tpu_torch.ops import connected_components as cc
    from ffs_tpu_torch.ops.compact import compact_from_pcw_segmented
    from ffs_tpu_torch.ops.dispersion_packed import dispersion_packed_raw

    imgs = torch.from_numpy(frames).to(dev)
    msk = torch.from_numpy(mask).to(dev)
    k = len(frames) // world
    per_frame, spots = [], []
    for r in range(world):
        part = imgs[r * k : (r + 1) * k]
        pcw = dispersion_packed_raw(part, msk, 65535.0)
        p, nbu, nbd, counts = compact_from_pcw_segmented(part, pcw,
                                                         max_pixels_per_frame=MULTI_KF,
                                                         with_neighbors=True)
        root = cc.label_compact_pixels(p, width=frames.shape[-1], neighbors=(nbu, nbd))
        table = cc.spot_table_from_pixels(p, root, width=frames.shape[-1], max_spots=MULTI_KF,
                                          dtype=torch.float32, frame_rows=frames.shape[1])
        per_frame.append(counts)
        spots.append(table.n_spots)
    per_frame = torch.cat(per_frame).cpu()
    return per_frame, torch.stack(spots).cpu(), per_frame.sum(dtype=torch.int32)


def phase_multi(dev, card: str, col, integ) -> dict:
    """Phase 17: the mesh functions over ``world`` ranks against the
    single-device path on ``cuda:0``, bit for bit, ``integ`` being phase
    7's integrator of the collection ``col``; returns each kernel's
    launches, one count a rank."""
    import dataclasses

    import torch

    from ffs_tpu_torch.io import sample_data
    from ffs_tpu_torch.ops import cc3d
    from ffs_tpu_torch.ops import dispersion as dops
    from ffs_tpu_torch.parallel import dryrun, rotation_frame_pixels
    from ffs_tpu_torch.parallel.launch import run_ranks
    from ffs_tpu_torch.tools.measure_stages import make_batch

    count = torch.cuda.device_count()
    world = min(count, MULTI_MAX_WORLD)
    if world >= 2:
        backend, how = "nccl", f"{world} cards, one rank a card (NCCL)"
    else:
        world, backend = 2, "gloo"
        how = "one card: 2 ranks share cuda:0, collectives through host memory (gloo)"
    say(f"multi-device: world {world}, backend {backend}: {how}; on {card}")

    t0 = time.perf_counter()
    mask = sample_data.generate_mask()
    batch = make_batch(8, mask, spots=300, seed=12)
    _, planes = to_planes(batch)
    sp = jungfrau_4m_frame()
    rot, centres = rotation_batch(batch)
    kab = kabsch_chunk(integ, col.frames)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="ffs_multi_") as store:
        for name, arr in (("frames", batch), ("planes", planes), ("mask", mask), ("sp", sp),
                          ("rot", rot), ("kframes", kab.pop("frames")), ("kmask", col.mask)):
            np.save(os.path.join(store, name + ".npy"), arr)
        say(f"multi-device set-up: {time.perf_counter() - t0:.1f} s")
        ranks, t_all = timed(lambda: run_ranks(
            multi_rank, world, backend=backend, timeout=900,
            args=(backend, store, kab, integrator_args(col.expt, integ))))
    r0 = ranks[0]
    say(f"multi-device: {world} ranks in {t_all:.1f} s (spawn, set-up and every part); rank "
        f"devices {[r['device'] for r in ranks]}")
    for r in ranks[1:]:
        for key in ("counts", "packed", "planes", "halo", "sp", "ext", "sp_rounds", "ext_rounds",
                    "kabsch", "rotation"):
            if not tensors_equal(r[key], r0[key]):
                fail(f"multi-device: {key} differs between rank 0 and another rank")

    # (a) DP against the single-device path on cuda:0
    want_counts = dops.dispersion(
        torch.from_numpy(batch).to(dev), torch.from_numpy(mask).to(dev), 65535.0,
        dtype=torch.float32).sum(dim=(-2, -1), dtype=torch.int32)
    want_packed = single_packed(batch, mask, world, dev)
    _, t_single = timed(lambda: single_packed(batch, mask, 1, dev))
    if not (tensors_equal(r0["counts"][0], want_counts)
            and int(r0["counts"][1]) == int(want_counts.sum())):
        fail("multi-device: sharded_spotfind_counts differs from the single-device threshold")
    for key in ("packed", "planes"):
        if not tensors_equal(tuple(r0[key]), want_packed):
            fail(f"multi-device: the {key} DP pipeline differs from the single-device path")
    ms = r0["ms"]
    say(f"multi-device (a) DP, B = 8 Eiger 16M: per-frame counts, spots per rank "
        f"{r0['packed'][1].tolist()} and total {int(r0['packed'][2])} equal the single-device "
        f"path, from frames and from planes; counts (f32 plain) {ms['counts']:.1f} ms, packed "
        f"{ms['packed']:.1f} ms = {8e3 / ms['packed']:.1f} frames/s at world {world} against "
        f"{8 / t_single:.1f} frames/s at world 1 ({1e3 * t_single:.1f} ms, host clock), planes "
        f"{ms['planes']:.1f} ms, on {card}")

    # (b) SP against the single-device packed path and ops.dispersion
    img = torch.from_numpy(sp).to(dev)
    ones = torch.ones(JF4M, dtype=torch.uint8, device=dev)
    if not tensors_equal(r0["halo"], dops.dispersion(img, ones, 65535.0, dtype=torch.float32)):
        fail("multi-device: halo_sharded_dispersion differs from ops.dispersion on one device")
    for key, extended in (("sp", False), ("ext", True)):
        table, total = r0[key]
        px, want = dryrun.single_table(sp, np.ones(JF4M, np.uint8), world * SP_CHIP_PX, SP_SPOTS,
                                       extended, dev)
        ns, want_total = int(want.n_spots), px.count
        bad = [f for f in want._fields if f != "n_spots"
               and not tensors_equal(getattr(table, f)[:ns], getattr(want, f)[:ns])]
        if int(table.n_spots) != ns or int(total) != int(want_total) or bad or ns == 0:
            fail(f"multi-device: SP {key} table differs from the single-device path: spots "
                 f"{int(table.n_spots)} / {ns}, total {int(total)} / {int(want_total)}, "
                 f"columns {bad}")
        crossing = int(((table.y_min[:ns] // (JF4M[0] // world))
                        != (table.y_max[:ns] // (JF4M[0] // world))).sum())
        if crossing == 0:
            fail(f"multi-device: SP {key}: no spot crosses a shard boundary")
        say(f"multi-device (b) SP{' extended' if extended else ''}, Jungfrau 4M: {ns} spots "
            f"({crossing} across shard boundaries), {int(total)} strong px, every column equal "
            f"to the single-device path; {r0[key + '_rounds']} merge rounds; "
            f"{ms[key]:.1f} ms on {card}")
    say(f"multi-device (b) halo_sharded_dispersion equals ops.dispersion (f32) on one device, "
        f"{ms['halo']:.1f} ms; an 11-row halo exchange of a {JF4M[0] // world}-row strip "
        f"{ms['halo_exchange']:.3f} ms ({backend}, mean of {HALO_REPS}) on {card}")

    # (c) the Kabsch block step against _block_step_impl on phase 7's integrator
    chunk = integ._chunk_setup(kab["chunk"], kab["cs_e1"], kab["cs_e2"], kab["zeta"])
    frames = integ.pad_frames(torch.from_numpy(col.frames[: integ.frame_block]).to(dev))
    want = integ._block_step_impl(
        frames, chunk, torch.from_numpy(kab["phi_lows"]).to(dev), kab["d_osc"],
        torch.from_numpy(kab["z_values"]).to(dev), torch.from_numpy(kab["frame_ok"]).to(dev),
        centre_slices=True)
    for i, (g, w) in enumerate(zip(r0["kabsch"], want)):
        if not tensors_equal(g, w):
            fail(f"multi-device: Kabsch output {i} differs from _block_step_impl")
    if int(want[1].sum()) == 0:
        fail("multi-device: the Kabsch chunk classified no foreground")
    say(f"multi-device (c) Kabsch, A = {len(kab['chunk'])}, F = {integ.frame_block}: all eight "
        f"outputs equal _block_step_impl ({int(want[1].sum())} foreground pixels); chunk set-up "
        f"{ms['kabsch_setup']:.1f} ms, step {ms['kabsch']:.1f} ms on {card}")

    # (d) the rotation chunk against the one-device Spots3D
    lin, inten, rl, pf, pitch = r0["rotation"]
    k = len(rot) // world
    got_frames = rotation_frame_pixels(lin, inten, rl, pf, pitch, MULTI_KF, k)
    _, want_frames, want_spots = dryrun.single_rotation(rot, mask, MULTI_KF, dev)
    spots = cc3d.merge_frames(got_frames, width=rot.shape[-1])
    if not all(tensors_equal(getattr(a, f.name), getattr(b, f.name))
               for a, b in zip(got_frames, want_frames)
               for f in dataclasses.fields(cc3d.FramePixels)):
        fail("multi-device: rotation frame pixels differ from the one-device path")
    if len(spots) != len(want_spots) or not all(
            tensors_equal(getattr(spots, f.name), getattr(want_spots, f.name))
            for f in dataclasses.fields(cc3d.Spots3D)):
        fail("multi-device: the rotation Spots3D differs from the one-device path")
    for b, y, x in centres:
        if b % k:
            continue  # not a rank boundary at this world
        hit = ((spots.z_min <= b - 1) & (spots.z_max >= b + 1) & (spots.y_min <= y)
               & (spots.y_max >= y + 3) & (spots.x_min <= x) & (spots.x_max >= x + 3))
        if not hit.any():
            fail(f"multi-device: no 3D spot spans the rank boundary before frame {b}")
    say(f"multi-device (d) rotation, B = 8 Eiger 16M: {len(spots)} 3D spots equal the one-device "
        f"Spots3D, planted spots span every rank boundary; {ms['rotation']:.1f} ms on {card}")

    launches = {name: [r["launches"][name] for r in ranks] for name in MULTI_KERNELS}
    say(f"multi-device kernel launches, one count a rank: {launches}")
    if min(min(n) for n in launches.values()) == 0:
        fail(f"multi-device: a rank did not launch a kernel of the path: {launches}")
    return launches


def multi_collection(dev):
    """Phase 7's collection and integrator, without phase 7's checks and
    times: what phase 17 needs when it runs alone."""
    import types

    from ffs_tpu_torch.io import sample_data
    from ffs_tpu_torch.pipeline.integrator import integrate_experiment
    from ffs_tpu_torch.prediction.rotation import predict_rotation

    expt = eiger_experiment()
    mask = sample_data.generate_mask()
    pred = predict_rotation(expt, device=dev)
    frames, _ = synth_collection(expt, pred, mask, dev)
    with contextlib.redirect_stdout(io.StringIO()):
        out = integrate_experiment(expt, {}, HostFrames(frames, mask), device=dev,
                                   sigma_b=np.deg2rad(SIGMA_B_DEG),
                                   sigma_m=np.deg2rad(SIGMA_M_DEG))
    return types.SimpleNamespace(expt=expt, frames=frames, mask=mask), out.integrator


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on the GPU.")
    ap.add_argument("--multi-only", action="store_true",
                    help="run phases 1, 2 and 17 (multi-device) alone, for a multi-card "
                         "machine; ends with a line of its own, not the smoke's result")
    args = ap.parse_args()
    # the smoke proves the port runs on its own: any import of JAX, of the
    # JAX package or of its benchmark fails
    for name in ("jax", "ffs_tpu", "bench"):
        sys.modules[name] = None
    if not (ROOT / "ffs_tpu_torch").is_dir():
        fail(f"run from the root of a checkout: no ffs_tpu_torch beside {__file__}")
    sys.path.insert(0, str(ROOT))
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    card = smi.splitlines()[0]
    say(f"card: {card}")
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 2: build
    from ffs_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    so_path = cuda_build.build()
    cuda_build.lib()
    say(f"build: {time.perf_counter() - t0:.1f} s -> {so_path.relative_to(ROOT)}")
    log = cuda_build.build_log().splitlines()
    for k, line in enumerate(log):  # ptxas: "Function properties for <kernel>", then its figures
        if "Function properties for" in line and "walker" in line:
            kernel = re.search(r"(dispersion_walker|extended_walker)I([tji])(Lb1)?", line)
            pixel = {"t": "u16", "j": "u32", "i": "i32"}[kernel.group(2)]
            signal = ", signal test" if kernel.group(3) else ""
            figures = " ".join(x.split(":", 1)[-1].strip() for x in log[k + 1 : k + 3])
            say(f"ptxas {kernel.group(1)}<{pixel}{signal}>: {figures}")

    # phase 3: kernels against their plain versions
    from ffs_tpu_torch.utils import torchinit

    torchinit.setup()
    if args.multi_only:
        col, integ = multi_collection(dev)
        launches = phase_multi(dev, card, col, integ)
        say(f"card: {card}")
        say(f"multi-device only: phases 1, 2 and 17 passed on {torch.cuda.device_count()} "
            f"card(s), launches {launches}; not the smoke's result")
        return 0
    max_err = phase_kernels(dev)

    # phase 4: main path
    fps, launches = phase_main_path()

    # phase 5: golden
    phase_golden(dev)

    # phase 6: times
    times = phase_times(dev)
    phase_processor(dev)
    for run, (cli_fps, seconds) in fps.items():
        say(f"cli {run}: {cli_fps} frames/s (CLI's own figure; run() {seconds:.2f} s "
            f"incl. set-up and host sample generation) on {card}")

    # phase 7: the integrator's main path
    col, integ_run, stage_t, launches_int = phase_integrator(dev)
    launches.update(launches_int)
    kabsch_s = stage_t["kabsch"]
    say(f"integrator stage breakdown on {card}:")
    for stage, dt in stage_t.items():
        say(f"    {stage:>14s}: {dt * 1000:8.1f} ms")
    say(f"integrate(): {col.slices} reflection-image slices in {kabsch_s:.3f} s = "
        f"{col.slices / kabsch_s:.0f} slices/s (real-time bar {REAL_TIME_SLICES}) on {card}")

    # phase 8: the gathers against their plain versions, with times
    gathers = phase_gathers(dev, integ_run.integrator, col.frames)
    say(f"gather times above on {card}")

    # phase 9: the decode kernel against its plain version, with times
    chunks, sample_planes = to_planes(sample_frames())
    decode = phase_decode(dev, sample_planes)
    say(f"decode times above on {card}")

    # phase 10: the batched main path, its golden and its rates
    launches["bitshuffle_frames"] = phase_batch_main_path(chunks)["bitshuffle_frames"]
    phase_batch_golden(dev, sample_planes)
    phase_batch_times(dev, sample_planes)
    say(f"processor rates above on {card}")

    # phase 11: the rowcum thresholds and the stage tool's main path
    rowcum, launches_rc = phase_rowcum(dev)
    launches.update(launches_rc)
    say(f"rowcum times above on {card}")

    # phase 12: the gather variants and the gather tool's main path
    variants, launches_gv = phase_gather_variants(dev, integ_run.integrator, col.frames)
    launches.update(launches_gv)
    say(f"gather variant times above on {card}")

    # phase 13: SSX indexing at the service's size
    phase_ssx(dev, card)

    # phase 14: rotation indexing at Eiger 16M
    phase_rotation(dev, card)

    # phase 15: the PIA's per-line indexing step on the spotfinder's pipe lines
    phase_pia_hook(dev, card)

    # phase 16: the integrator's --bg-device path, at phase 7's size and at
    # the whole sweep's, and the predictor CLI on a scan of the sweep's
    # configuration
    phase_bg_device(dev, card, col, integ_run.acc)
    phase_bg_device_sweep(dev, card, col.slices / kabsch_s)
    phase_predictor_cli(dev, card)

    # phase 17: multi-device, the mesh functions over 2-4 ranks
    launches_multi = phase_multi(dev, card, col, integ_run.integrator)

    sources = {
        "dispersion_packed": ("ffs_tpu_torch/csrc/dispersion_packed.cu",
                              "ffs_tpu/ops/dispersion_pallas.py:468"),
        "dispersion_extended_packed": ("ffs_tpu_torch/csrc/dispersion_extended_packed.cu",
                                       "ffs_tpu/ops/dispersion_extended_pallas.py:173"),
        "window_gather_planes": ("ffs_tpu_torch/csrc/window_gather.cu",
                                 "ffs_tpu/ops/window_gather.py:39"),
        "window_gather": ("ffs_tpu_torch/csrc/window_gather.cu",
                          "ffs_tpu/ops/window_gather.py:460"),
        "bitshuffle_frames": ("ffs_tpu_torch/csrc/bitshuffle_frames.cu",
                              "ffs_tpu/ops/frame_assemble.py:55"),
        "dispersion_fused": ("ffs_tpu_torch/csrc/dispersion_packed.cu",
                             "ffs_tpu/ops/dispersion_pallas.py:294"),
        "dispersion_extended_fused": ("ffs_tpu_torch/csrc/dispersion_extended_packed.cu",
                                      "ffs_tpu/ops/dispersion_extended_pallas.py:173"),
        "window_gather_planes_packed": ("ffs_tpu_torch/csrc/window_gather.cu",
                                        "ffs_tpu/ops/window_gather.py:170"),
        "window_gather_planes_pl": ("ffs_tpu_torch/csrc/window_gather.cu",
                                    "ffs_tpu/ops/window_gather.py:327"),
        "window_gather_probe": ("ffs_tpu_torch/csrc/window_gather.cu",
                                "tools/measure_window_gather.py:58"),
    }
    figures = {
        name: {"max_abs_err": max_err[name], "ms": t[0], "plain_ms": t[1],
               "bound": (t[2], t[3]), "library_ms": None}
        for name, t in times.items()
    }
    figures.update(gathers)
    figures.update(decode)
    figures.update(rowcum)
    figures.update(variants)
    summary = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": figures[name]["max_abs_err"],
            "ms": figures[name]["ms"],
            "plain_ms": figures[name]["plain_ms"],
            "bound_ms": figures[name]["bound"][0],
            "bound_by": figures[name]["bound"][1],
            "library_ms": figures[name]["library_ms"],
            "multi_launches": launches_multi.get(name),
        }
        for name, (src, replaces) in sources.items()
    ]}
    say(f"card: {card}")
    say(json.dumps(summary))
    say(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
