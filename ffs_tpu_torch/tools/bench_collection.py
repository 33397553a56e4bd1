"""End-to-end benchmark of a whole collection through the spotfinder CLI.

    python -m ffs_tpu_torch.tools.bench_collection

Counterpart of the repo's ``tools/bench_collection.py``.  It writes a
synthetic compressed Eiger 16M collection in the /dev/shm stream layout
(4362 x 4148 u16 Poisson(2) frames under the detector's module mask, ~300
3x3 spots a frame that move every second frame, each frame bitshuffle-LZ4
compressed by the port's codec; the JAX tool's seeds) and runs
the spotfinder CLI on it in a subprocess, with ``--wavelength 0.976
--min-spot-size 1 --save-h5`` and ``--threads`` set to the host's cores (at
most 40, the service's default).  That is the path
the service runs: SHM read, decode on the host or the card, upload,
threshold, compaction, CC, the 3D merge, the sigma estimates and the HDF5
table.

Modes (``FFS_COLL_MODES``, default ``f64,host,device``), one metric line
each, named as in the JAX tool:

* ``f64``, ``collection_end_to_end_fps_f64_default``: the CLI's default
  precision, which the service runs (it passes no ``--precision``): per
  frame, the plain float64 threshold and device CC;
* ``host`` and ``device``, ``collection_end_to_end_fps_{host,device}_decode``:
  ``--precision f32 --batch B --decode-backend host|device``, the kernel
  path in batches of ``FFS_COLL_BATCH`` (default 8).

Two quirks of the JAX tool are not copied: it passes no ``--precision``, so
its CLI falls back from ``--batch`` and device decode to the per-frame f64
path and both of its lines time that path; and its header has no omega, so
its CLI takes the still-set path (2D centroids, no 3D merge).  Here the
header carries ``omega_start`` and ``omega_increment`` (0.1 degree frames).

Each metric line carries the CLI's own fps and GBps (the time from its
first frame to its last line), the subprocess's wall seconds (interpreter
start, set-up and kernel loading included), the frames processed, the
threads, the card's name and power limit, how the table was written, and
the launches of TPU kernel rows 1-5 and of the float64 walker
(``ffs_tpu_torch.ops.kernel_wrappers``) in the run.
A traced run of the device-decode mode follows (the CLI's ``--jax-profile``,
a torch.profiler trace of its collection loop): the device's busy share of
the trace's span (the union of its kernels' and copies' intervals), the
device ms by kind and the five device events with the most time; the
profiler slows the run, so its fps is not the mode's.  A stage-split line
follows: the mean ms a frame of each stage that
``--profile`` prints (per frame, host decode), at f64 and at f32, over
frames 1-7 (frame 0 warms up), and the host decode and LZ4-only ms of one
frame; then the upload share, the upload stage over the frame's total, at
f64 and at f32.

Exits 1 when a CLI run fails, when any run prints a fallback notice
("Batched mode unavailable", "Device decode unavailable"), or when the
``host`` and ``device`` runs disagree: their spot tables must be equal bit
for bit, and so must each image's strong-pixel and spot counts.  Without a
CUDA card it exits non-zero unless ``FFS_TORCH_DEVICE=cpu`` asks for the
CPU, where the f32 modes need the CLI's ``FFS_TORCH_KERNEL_PATH=1`` hook
(the f64 runs drop it, so that they run the f64 path as on the card).

Each CLI run is ``python -m ffs_tpu_torch.tools.bench_collection --cli
ARGS``: ``pipeline.spotfinder.run(ARGS)``, what ``python -m
ffs_tpu_torch.pipeline.spotfinder ARGS`` runs, followed by one line of the
kernel wrappers' launches.  Where h5py is not installed, it writes the
table's columns to ``results_ffs.h5.npz`` instead of HDF5, and the metric
lines say so (``"table"``).

``FFS_COLL_FRAMES`` (default 32) sets the frames.  The collection is built
under a temporary directory and removed at the end.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from ..constants import E2XE_16M_FAST, E2XE_16M_SLOW

SHAPE = (E2XE_16M_SLOW, E2XE_16M_FAST)  # (H, W)
ROOT = pathlib.Path(__file__).resolve().parents[2]  # the directory above the package
CLI = ("ffs_tpu_torch.tools.bench_collection", "--cli")
FPS_RE = re.compile(r"(\d+) images in ([0-9.]+) s \(([0-9.]+) GBps\) \(([0-9.]+) fps\)")
IMAGE_RE = re.compile(
    r"Thread\s+0 finished image\s+(\d+) with\s+(\d+) strong pixels,\s+(\d+) filtered "
    r"reflections \((\d+) pixels\)"
)
STAGE_RE = re.compile(r"^ {4}\s*(\S.*?):\s+([0-9.]+) ms$")
FALLBACKS = ("Batched mode unavailable", "Device decode unavailable")
METRICS = {
    "f64": "collection_end_to_end_fps_f64_default",
    "host": "collection_end_to_end_fps_host_decode",
    "device": "collection_end_to_end_fps_device_decode",
}
PROFILE_FRAMES = 8
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device events of a torch.profiler trace
TABLE = "results_ffs.h5"


class CollectionError(RuntimeError):
    """A failed run, a fallback notice, or a disagreement between modes."""


def collection_mask() -> np.ndarray:
    """The Eiger 16M module mask (1 on module pixels)."""
    from ..io import sample_data

    return sample_data.generate_mask()


def build_collection(d: pathlib.Path, n_frames: int) -> int:
    """Writes the synthetic compressed collection into ``d`` in the SHM
    layout; returns its compressed bytes."""
    from ..io import compression

    h, w = SHAPE
    rng = np.random.default_rng(5)
    mask = collection_mask()
    base = rng.poisson(2.0, size=(h, w)).astype(np.uint16)
    base[mask == 0] = 0
    header = {
        "nimages": n_frames,
        "ntrigger": 1,
        "y_pixels_in_detector": h,
        "x_pixels_in_detector": w,
        "bit_depth_image": 16,
        "countrate_correction_count_cutoff": 65530,
        "wavelength": 0.976,
        "detector_distance": 250.0,
        "y_pixel_size": 7.5e-05,
        "x_pixel_size": 7.5e-05,
        "beam_center_y": h / 2.0,
        "beam_center_x": w / 2.0,
        "omega_start": 0.0,
        "omega_increment": 0.1,
    }
    (d / "start_1").write_text(json.dumps(header))
    (d / "start_4").write_text("{}")
    (d / "start_5").write_bytes(np.zeros((h, w), np.int32).tobytes())
    total_bytes = 0
    t0 = time.perf_counter()
    for i in range(n_frames):
        f = base.copy()
        # ~300 3x3 spots a frame, each set kept for two frames so that the
        # 3D merge joins spots across frames
        frng = np.random.default_rng(100 + i // 2)
        ys = frng.integers(8, h - 8, 300)
        xs = frng.integers(8, w - 8, 300)
        f[ys, xs] += 600
        f[ys + 1, xs] += 400
        f[ys, xs + 1] += 350
        f[mask == 0] = 0
        blob = compression.bshuf_lz4_compress(f, 2)
        (d / f"image_{i:06d}_2").write_bytes(bytes(blob))
        total_bytes += len(blob)
    print(f"built a {n_frames}-frame {h} x {w} collection, {total_bytes / 1e6:.1f} MB "
          f"compressed, in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return total_bytes


def cli_env(kernel_hook: bool) -> dict:
    """The CLI subprocess's environment: the package importable from any
    working directory; the CPU kernel-path hook only where ``kernel_hook``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    if not kernel_hook:
        env.pop("FFS_TORCH_KERNEL_PATH", None)
    return env


def run_cli(src, workdir: pathlib.Path, extra: list[str],
            kernel_hook: bool = True) -> tuple[str, float]:
    """One spotfinder CLI run in a subprocess -> (stdout, wall seconds).
    Raises CollectionError on a non-zero exit or a fallback notice."""
    workdir.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", *CLI, os.fspath(src), "--wavelength", "0.976",
           "--min-spot-size", "1", "--save-h5", *extra]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=workdir,
                       env=cli_env(kernel_hook), timeout=3600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        print(r.stdout[-2000:], r.stderr[-4000:], sep="\n", file=sys.stderr)
        raise CollectionError(f"CLI {' '.join(extra)} exited {r.returncode}")
    notices = [line for line in r.stdout.splitlines() if line.startswith(FALLBACKS)]
    if notices:
        raise CollectionError(f"CLI {' '.join(extra)} fell back: {notices}")
    return r.stdout, wall


def read_table(workdir: pathlib.Path) -> tuple[dict, str]:
    """The spot table a CLI run wrote -> ({column: array}, how it was written)."""
    path = workdir / TABLE
    if path.exists():
        from ..models.reflection_table import ReflectionTable

        table = ReflectionTable.read(str(path))
        return {name: table[name] for name in table.column_names()}, "hdf5"
    with np.load(str(path) + ".npz") as z:
        return {name: z[name] for name in z.files}, "npz (h5py not installed)"


def launches(out: str) -> dict[str, int]:
    """The kernel launches the ``--cli`` run printed last."""
    return json.loads(out.strip().splitlines()[-1])["launches"]


def image_counts(out: str) -> list[tuple[int, ...]]:
    """(image, strong pixels, filtered reflections, their pixels) a frame."""
    return [tuple(int(g) for g in m.groups()) for m in IMAGE_RE.finditer(out)]


def tables_differ(a: dict, b: dict) -> list[str]:
    """The columns in which two spot tables are not equal bit for bit."""
    if sorted(a) != sorted(b):
        return [f"columns {sorted(a)} != {sorted(b)}"]
    return [name for name in a if a[name].dtype != b[name].dtype
            or a[name].shape != b[name].shape or a[name].tobytes() != b[name].tobytes()]


def stage_means(out: str) -> dict[str, float]:
    """Mean ms a frame of each ``--profile`` stage over frames 1.. (frame 0
    warms up), with the frame's total."""
    frames: list[dict] = []
    for line in out.splitlines():
        if IMAGE_RE.search(line):
            frames.append({})
        elif frames and (m := STAGE_RE.match(line)):
            frames[-1][m.group(1)] = float(m.group(2))
    kept = frames[1:] or frames
    if not kept or not kept[0]:
        raise CollectionError("the --profile run printed no stages")
    means = {k: float(np.mean([f[k] for f in kept])) for k in kept[0]}
    means["total"] = float(np.mean([sum(f.values()) for f in kept]))
    return means


def trace_summary(path: pathlib.Path) -> dict:
    """The device's share of a CLI ``--jax-profile`` trace: the union of its
    kernels' and copies' intervals over the profiler's window (its "Trace"
    span), the device ms by kind, and the five device events (by name)
    with the most time.  ``busy_share`` is None where the trace holds no
    device event (the CPU)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    span_us = max(e["dur"] for e in events if e.get("cat") == "Trace")
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    by_kind: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in device:
        by_kind[e["cat"]] = by_kind.get(e["cat"], 0.0) + e["dur"] / 1e3
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"span_ms": span_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / span_us if device else None, "device_ms": by_kind,
            "top": [{"name": name[:80], "ms": ms} for name, ms in top]}


def mode_args(mode: str, n_frames: int, batch: str) -> list[str]:
    if mode == "f64":
        return ["--images", str(n_frames)]
    if mode in ("host", "device"):
        return ["--precision", "f32", "--batch", batch, "--decode-backend", mode,
                "--images", str(n_frames)]
    raise ValueError(f"unknown mode {mode!r}: expected f64, host or device")


def host_decode_ms(src: pathlib.Path) -> dict[str, float]:
    """Host bitshuffle-LZ4 decode and LZ4-only ms of frame 0 (3 reps), the
    reader threads' stage that --profile cannot see."""
    from ..io import compression

    blob = (src / "image_000000_2").read_bytes()
    npix = SHAPE[0] * SHAPE[1]
    res = {}
    for name, fn in (("decode_host_ms", compression.bshuf_lz4_decompress),
                     ("decode_lz4_only_ms", compression.bshuf_lz4_planes)):
        t0 = time.perf_counter()
        for _ in range(3):
            fn(blob, npix, 2)
        res[name] = (time.perf_counter() - t0) / 3 * 1e3
    return res


def run(n_frames: int, modes: list[str], batch: str, device_tag: str) -> None:
    """Builds the collection, runs every mode and the stage split, prints
    the metric lines; raises CollectionError on any failure."""
    threads = str(min(os.cpu_count() or 1, 40))
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="ffs_coll_"))
    src = tmp / "shm"
    try:
        src.mkdir()
        nbytes = build_collection(src, n_frames)
        raw_gb = SHAPE[0] * SHAPE[1] * 2 * n_frames / 1e9
        results = {}
        for mode in modes:
            work = tmp / mode
            out, wall = run_cli(src, work, [*mode_args(mode, n_frames, batch),
                                            "--threads", threads],
                                kernel_hook=mode != "f64")
            table, how = read_table(work)
            m = FPS_RE.search(out)
            if not m or int(m.group(1)) != n_frames:
                raise CollectionError(f"{mode}: no fps line for {n_frames} images")
            counts = image_counts(out)
            results[mode] = (table, counts)
            print(json.dumps({
                "metric": METRICS[mode],
                "value": float(m.group(4)),
                "unit": "frames/s, the CLI's own figure (first frame to its last line: SHM "
                        "read, decode, upload, threshold, CC, 3D merge, sigma, table)",
                "gbps": float(m.group(3)),
                "cli_s": float(m.group(2)),
                "wall_s": wall,
                "frames": n_frames,
                "compressed_gb": nbytes / 1e9,
                "raw_gb": raw_gb,
                "spots": len(next(iter(table.values()))) if table else 0,
                "strong_pixels": sum(c[1] for c in counts),
                "threads": int(threads),
                "batch": int(batch) if mode != "f64" else 1,
                "table": how,
                "launches": launches(out),
                "device": device_tag,
                "vs_baseline": float(m.group(4)) / 500.0,
            }), flush=True)
        if "host" in results and "device" in results:
            (t_h, c_h), (t_d, c_d) = results["host"], results["device"]
            bad = tables_differ(t_h, t_d)
            if bad or c_h != c_d:
                raise CollectionError(
                    f"host and device decode disagree: table columns {bad}, per-image counts "
                    f"{'equal' if c_h == c_d else 'differ'}")
            print(json.dumps({"check": "host_vs_device_decode", "ok": True,
                              "spots": len(next(iter(t_h.values()))) if t_h else 0,
                              "images": len(c_h)}), flush=True)

        if "device" in modes:
            # where the time goes in the device-decode mode: a traced run
            trace_dir = tmp / "trace"
            out, _ = run_cli(src, tmp / "traced", [*mode_args("device", n_frames, batch),
                                                   "--threads", threads,
                                                   "--jax-profile", str(trace_dir)])
            m = FPS_RE.search(out)
            print(json.dumps({"metric": "collection_device_busy", "mode": "device",
                              **trace_summary(trace_dir / "trace.json"),
                              "traced_fps": float(m.group(4)) if m else None,
                              "frames": n_frames, "device": device_tag}), flush=True)

        # the stage split: --profile runs per frame with host decode
        k = str(min(n_frames, PROFILE_FRAMES))
        split = {}
        for prec in ("f64", "f32"):
            extra = ["--profile", "--decode-backend", "host", "--images", k, "--threads", threads]
            if prec == "f32":
                extra += ["--precision", "f32"]
            out, _ = run_cli(src, tmp / f"profile_{prec}", extra, kernel_hook=prec == "f32")
            split[prec] = stage_means(out)
        decode = host_decode_ms(src)
        print(json.dumps({"metric": "collection_stage_split_ms_mean", **split, **decode,
                          "frames": int(k) - 1, "device": device_tag}), flush=True)
        print(json.dumps({
            "metric": "collection_upload_share",
            **{prec: s["upload"] / s["total"] for prec, s in split.items()},
            "upload_ms": {prec: s["upload"] for prec, s in split.items()},
            "total_ms": {prec: s["total"] for prec, s in split.items()},
            "device": device_tag,
        }), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cli_main(argv: list[str]) -> int:
    """``spotfinder.run(argv)``, then a line of the kernel launches it
    made.  Where h5py is missing (``ReflectionTable.write`` needs it), the
    table's columns go to ``<path>.npz``."""
    from ..ops import kernel_wrappers
    from ..models.reflection_table import ReflectionTable
    from ..pipeline import spotfinder

    try:
        import h5py  # noqa: F401
    except ImportError:
        def write_npz(self, path, *args, **kwargs):
            np.savez(str(path) + ".npz", **{k: self[k] for k in self.column_names()})

        ReflectionTable.write = write_npz
    rc = spotfinder.run(argv)
    print(json.dumps({"launches": {k: fn.launches for k, fn in kernel_wrappers().items()}}))
    return rc


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--cli"]:
        return cli_main(argv[1:])
    from ..utils import torchinit

    device = torchinit.select_device()
    if device.type == "cuda":
        from ..bench import card_name
        from ..utils import cuda_build

        device_tag = card_name(device)
        cuda_build.lib()  # build once here, so that each CLI run only loads it
    else:
        device_tag = "host CPU"
    n_frames = int(os.environ.get("FFS_COLL_FRAMES", "32"))
    modes = os.environ.get("FFS_COLL_MODES", "f64,host,device").split(",")
    batch = os.environ.get("FFS_COLL_BATCH", "8")
    for mode in modes:
        mode_args(mode, n_frames, batch)  # an unknown mode fails before the build
    print(json.dumps({"collection": f"{SHAPE[0]} x {SHAPE[1]} u16", "frames": n_frames,
                      "modes": modes, "batch": int(batch), "device": device_tag}), flush=True)
    try:
        run(n_frames, modes, batch, device_tag)
    except CollectionError as e:
        print(f"bench_collection: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
