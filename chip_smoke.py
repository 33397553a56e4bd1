"""Smoke run of the PyTorch/CUDA spotfinder on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and nvcc.  It
needs no network and no JAX (JAX is blocked from import).  Phases, each of
which fails the run:

1. device — a CUDA device must exist; prints the card's name and power limit;
2. build — compiles every CUDA kernel from ``ffs_tpu_torch/csrc`` with nvcc;
3. kernels — each kernel against its plain PyTorch version on the card, bit
   for bit over the whole packed output, on full Eiger 16M frames (sample
   images 2 and 5, a seeded Poisson frame with spots and module gaps, a u32
   frame with 0xFFFFFFFF sentinels), with and without the mask box count;
4. main path — the ``spotfinder`` CLI in-process on the six sample frames,
   f32 (kernels) and f64, both algorithms, reading the pipe JSON and holding
   the anchors (image 2: 9506 px / 9506 spots; image 5: 2388 px / 2311
   spots, extended 3 px); the kernels' launch counters must rise;
5. golden — the f32 pixel lists and host spot tables of images 2 and 5
   against tests/data/bench_anchor_golden.npz (bench's comparison plus
   peak_intensity);
6. times — kernel and plain version per algorithm at Eiger 16M with CUDA
   events, the CLI's frames/s, and the processor's steady frames/s and
   per-stage times on frames already in host memory.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, without that line, on
any failure.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import time
import types

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SIDE = 4362, 4148  # Eiger 16M (H, W)


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


def seeded_frames():
    """(name, frame, mask) test inputs at Eiger 16M besides the samples."""
    from ffs_tpu.io import sample_data

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


def phase_kernels(dev):
    """Every kernel against its plain version; returns per-kernel max error."""
    import torch

    from ffs_tpu.io import sample_data
    from ffs_tpu_torch.ops import dispersion_extended_packed as dxp
    from ffs_tpu_torch.ops import dispersion_packed as dp

    mask_np = sample_data.generate_mask()
    inputs = [
        (f"sample_{i}", sample_data.generate_sample_image(i), mask_np) for i in (2, 5)
    ] + seeded_frames()
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


def run_cli(args: list[str]):
    """The port's CLI in-process; returns (rc, log, pipe JSON lines, seconds)."""
    from ffs_tpu_torch.pipeline import spotfinder

    r, w = os.pipe()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = spotfinder.run(args + ["--pipe_fd", str(w)])
    seconds = time.perf_counter() - t0
    with os.fdopen(r) as f:  # run() closed the write end
        lines = [json.loads(line) for line in f if line.strip()]
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
    import bench
    from ffs_tpu.io import sample_data
    from ffs_tpu.ops.cc2d_host import cc2d
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
        table = types.SimpleNamespace(
            valid=np.ones(s, bool), z_min=np.zeros(s, np.int64), com_z=np.full(s, 0.5),
            **{c: getattr(t, c) for c in (
                "n_pixels", "x_min", "x_max", "y_min", "y_max", "peak_x", "peak_y",
                "sum_intensity", "com_x", "com_y",
            )},
        )
        errs = bench._check_anchor_bitparity(golden, tag, w, h + 1, 0, lin, inten, table)
        if not np.array_equal(
            t.peak_intensity.astype(np.int64), golden[f"{tag}_peak_intensity"].astype(np.int64)
        ):
            errs.append(f"{tag}: column peak_intensity differs")
        if errs:
            fail("; ".join(errs))
        say(f"golden {tag}: {len(lin)} px, {s} spots, every column equal (incl. peak_intensity)")


def phase_times(dev):
    """Kernel and plain version at Eiger 16M (sample image 5), device ms."""
    import torch

    from ffs_tpu.io import sample_data
    from ffs_tpu_torch.ops import dispersion_extended_packed as dxp
    from ffs_tpu_torch.ops import dispersion_packed as dp

    img = torch.from_numpy(sample_data.generate_sample_image(5)).to(dev)
    msk = torch.from_numpy(sample_data.generate_mask()).to(dev)
    out = {}
    for name, raw, plain, mbox_fn in (
        ("dispersion_packed", dp.dispersion_packed_raw, dp.dispersion_packed_plain, dp.mask_box_count),
        ("dispersion_extended_packed", dxp.dispersion_extended_packed_raw,
         dxp.dispersion_extended_packed_plain, dxp.mask_box_count_extended),
    ):
        mbox = mbox_fn(msk)
        # plain, kernel, kernel, plain: the means of each pair
        p1 = cuda_ms(lambda: plain(img, msk, 65535.0), 10)
        k1 = cuda_ms(lambda: raw(img, msk, 65535.0, mbox=mbox), 50)
        k2 = cuda_ms(lambda: raw(img, msk, 65535.0, mbox=mbox), 50)
        p2 = cuda_ms(lambda: plain(img, msk, 65535.0), 10)
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        say(f"time {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms per Eiger 16M frame")
    return out


def phase_processor(dev):
    """Steady per-frame processor rate on the six sample frames held in host
    memory (no sample generation in the loop), and one frame's stages."""
    import torch

    from ffs_tpu.io import sample_data
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


def main() -> int:
    # the smoke proves the port runs without JAX: any import of it fails
    sys.modules["jax"] = None
    if not (ROOT / "ffs_tpu_torch").is_dir() or not (ROOT / "ffs_tpu").is_dir():
        fail(f"run from the root of a checkout: no ffs_tpu_torch/ffs_tpu beside {__file__}")
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

    # phase 3: kernels against their plain versions
    from ffs_tpu_torch.utils import torchinit

    torchinit.setup()
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

    sources = {
        "dispersion_packed": ("ffs_tpu_torch/csrc/dispersion_packed.cu",
                              "ffs_tpu/ops/dispersion_pallas.py:468"),
        "dispersion_extended_packed": ("ffs_tpu_torch/csrc/dispersion_extended_packed.cu",
                                       "ffs_tpu/ops/dispersion_extended_pallas.py:173"),
    }
    summary = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
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
