"""The benchmark of the spotfinder service path.

    python -m ffsbench.run --workload CELL --seed N --seconds S --trace 0|1

The harness stands in for the service, not for the program.  It makes a
detector stream from the seed (``ffsbench.stream``, in a process of its own),
spawns the spotfinder CLI as the service does (``service/pia.py``: the image
count, ``--start-index 0``, ``--threads`` the host's cores up to 40,
``--pipe_fd``, ``--detector`` JSON, ``--wavelength``, then the
configuration's own flags) and reads one JSON line an image from the pipe,
stamping each with the host clock.

* Set-up (``setup_s``): from this process's start to the last of the
  traffic's warm-up lines.
* Window of S seconds from there.  ``catchup``: the stream stays
  ``ahead_frames`` ahead of the lines (a finished collection, or a late
  start); at the end the harness sends SIGINT and the CLI stops intake and
  runs its epilogue.  ``live``: after ``ahead_frames`` more at warm-up
  (the CLI writes a line once later frames are dispatched behind it), image
  i of the window is released at t0 + i / rate_hz, an open loop; the CLI's
  image count ends with the last release.
* After the window: the CLI closes its pipe (the ``finish:`` line times
  it from the end of intake) and exits; then the frames are made again
  from the seed, the plain reference (``ffsbench.reference``)
  works out what every line and the spot table should say, and
  ``ffsbench.compare`` holds the run to it.

With ``--trace 1`` the CLI also writes a torch.profiler trace
(``--jax-profile``) that the per-layer metrics read; it is deleted after.
Every metric is read by its own file, ``ffsbench/metrics/<name>.py``, from
the run's record; the cell's configuration and traffic come from
``ffsbench/configs/<config>.json`` and ``ffsbench/traffic/<traffic>.json``.

``--control program|reference`` runs a control instead of a benchmark run,
as the configuration's ``control`` block says: ``program`` adds its
``program_flags`` (the program's own lower-precision path) to the CLI's
command line; ``reference`` puts the reference in the program's place, its
threshold in ``control.threshold`` and its spot tables in
``control.tables``.  The benchmark's own runs never use it.

The last line on standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared beside its limit); the numbers also go
to standard error as its last lines.  Exits non-zero, printing no result,
without a CUDA card (unless ``FFS_TORCH_DEVICE=cpu`` asks for a CPU run),
without the program beside the benchmark, when the CLI fails, or when JAX
or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

from . import trace as tracing  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "ffsbench"
PROGRAM = "ffs_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "ffs_tpu")
FIRST_LINE_TIMEOUT_S = 1100.0  # a checkout's first run builds the program's kernels
EXIT_TIMEOUT_S = 200.0


class BenchError(RuntimeError):
    """A run that cannot give a result."""


@dataclass
class Run:
    """What a run recorded; the metric readers take their numbers from it."""

    workload: dict
    config: dict
    config_file: pathlib.Path
    traffic: dict
    seconds: float
    t_start: float
    t_spawn: float = 0.0
    unix_spawn: float = 0.0  # the spawn on the wall clock, which the CLI's own stamps use
    cli_imported_unix: float = 0.0  # the CLI's stamp: its imports done
    t0: float = 0.0  # the last warm-up line: the window opens
    t_end: float = 0.0  # the end of intake (SIGINT, or the last release)
    t_eof: float = 0.0  # the CLI closed its pipe: its run is over, the table written
    t_exit: float = 0.0
    lines: list = field(default_factory=list)  # (host time, payload) in arrival order
    due: dict = field(default_factory=dict)  # live: image -> due time
    late: dict = field(default_factory=dict)  # live: image -> release lateness
    cli_stdout: str = ""
    trace: tracing.Trace | None = None  # a --trace 1 run's trace

    @property
    def frames(self) -> int:
        return len(self.lines)


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def cell(name: str):
    """(manifest, workload, configuration's file, traffic's file) of a cell."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    workload = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if workload is None:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in manifest["configs"] if c["name"] == workload["config"])
    return manifest, workload, ROOT / entry["file"], HERE / "traffic" / f"{workload['traffic']}.json"


def cell_metrics(manifest: dict, workload: str, trace: bool) -> list[dict]:
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def read_metric(name: str, run: Run):
    """The metric's own reader, ``ffsbench/metrics/<name>.py``: read(run)."""
    spec = importlib.util.spec_from_file_location(f"ffsbench_metric_{len(name)}_{abs(hash(name))}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def say(msg: str) -> None:
    print(f"ffsbench: {msg}", file=sys.stderr, flush=True)


def card_info(chips: int) -> dict:
    """The device block of the result; raises without the card(s) the cell asks for."""
    import torch

    if os.environ.get("FFS_TORCH_DEVICE") == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise BenchError(f"the cell asks for {chips} CUDA card(s); "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                         "available")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class PipeReader(threading.Thread):
    """Reads the CLI's pipe, stamping each JSON line on arrival."""

    def __init__(self, fd: int, record: Run):
        super().__init__(daemon=True)
        self.fd, self.record, self.cond = fd, record, threading.Condition()

    def run(self):  # the thread's body
        with os.fdopen(self.fd, "r") as pipe:
            for raw in pipe:
                t = time.perf_counter()
                raw = raw.strip()
                if raw:  # parsed after the window, to keep this thread light
                    with self.cond:
                        self.record.lines.append((t, raw))
                        self.cond.notify_all()
        self.record.t_eof = time.perf_counter()

    def count(self) -> int:
        with self.cond:
            return len(self.record.lines)

    def wait_for(self, n: int, timeout: float, proc: subprocess.Popen) -> None:
        deadline = time.perf_counter() + timeout
        with self.cond:
            while len(self.record.lines) < n:
                if proc.poll() is not None:
                    raise BenchError(f"the CLI exited ({proc.returncode}) after "
                                     f"{len(self.record.lines)} of {n} warm-up lines")
                left = deadline - time.perf_counter()
                if left <= 0:
                    raise BenchError(f"{len(self.record.lines)} of {n} warm-up lines in {timeout} s")
                self.cond.wait(min(left, 0.5))


def service_command(run: Run, stream: pathlib.Path, images: int, write_fd: int,
                    extra: list[str]) -> list[str]:
    """The CLI's command line as the service builds it, then the
    configuration's flags."""
    cfg = run.config
    det, geo = cfg["detector"], cfg["geometry"]
    px = det["pixel_size_mm"]
    detector = {"distance": geo["distance_mm"], "beam_center_x": geo["beam_center_px"][0] * px,
                "beam_center_y": geo["beam_center_px"][1] * px, "pixel_size_x": px,
                "pixel_size_y": px}
    threads = min(os.cpu_count() or 1, 40)
    return [sys.executable, "-m", "ffsbench.cli", str(stream), "--images", str(images),
            "--start-index", "0", "--threads", str(threads), "--pipe_fd", str(write_fd),
            "--detector", json.dumps(detector), "--wavelength", str(geo["wavelength_A"]),
            *cfg["spotfinder"]["cli_flags"], *extra]


def cli_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    cache = HERE / "_cache"
    env["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    env["TRITON_CACHE_DIR"] = str(cache / "triton")
    return env


def start_stream(config_file: pathlib.Path, traffic_file: pathlib.Path, seed: int,
                 tmp: pathlib.Path) -> subprocess.Popen:
    """The process that makes the stream (``ffsbench.stream``), started
    first so that the harness's own start overlaps it."""
    return subprocess.Popen(
        [sys.executable, "-m", "ffsbench.stream", str(config_file), str(traffic_file),
         str(seed), str(tmp / "stream"), str(os.cpu_count() or 1)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=cli_env())


def drive(run: Run, tmp: pathlib.Path, maker: subprocess.Popen, trace: bool,
          control: str | None) -> dict:
    """Set-up, window and finish; returns the stream's info."""
    from .stream import HEADER_IMAGES, release

    tr = run.traffic
    k, warm = tr["distinct_frames"], tr["warmup_frames"]
    stream, work = tmp / "stream", tmp / "work"
    work.mkdir()
    out, err = maker.communicate(timeout=600)
    if maker.returncode != 0:
        raise BenchError(f"making the stream failed:\n{err[-3000:]}")
    info = json.loads(out.strip().splitlines()[-1])
    say(f"stream: {k} distinct frames, {info['raw_bytes']} raw bytes, "
        f"{info['compressed_bytes']} compressed; made {info['make_s']:.3f} s, "
        f"encoded {info['encode_s']:.3f} s, written {info['write_s']:.3f} s, ready at "
        f"{time.perf_counter() - T_START:.3f} s")

    live = tr["arrival"] == "live"
    n_live = round(tr["rate_hz"] * run.seconds) if live else 0
    first = warm + tr["ahead_frames"]  # a live window's first release
    images = first + n_live if live else HEADER_IMAGES
    extra = []
    if trace:
        extra += ["--jax-profile", str(tmp / "trace")]
    if control == "program":
        flags = run.config["control"].get("program_flags")
        if not flags:
            raise BenchError("the configuration names no lower-precision path of the program")
        extra += flags
    released = 0

    def release_to(n: int) -> None:
        nonlocal released
        while released < n:
            release(stream, released, k)
            released += 1

    # the CLI writes a frame's line once later frames are dispatched behind it
    # (its dispatch-ahead pipeline), so warm-up releases ``ahead_frames``
    # past the warm-up frames in either arrival; a live window's schedule
    # starts after them
    release_to(warm + tr["ahead_frames"])
    read_fd, write_fd = os.pipe()
    command = service_command(run, stream, images, write_fd, extra)
    out_path, err_path = work / "cli.out", work / "cli.err"
    with open(out_path, "w") as out, open(err_path, "w") as err:
        run.t_spawn, run.unix_spawn = time.perf_counter(), time.time()
        proc = subprocess.Popen(command, stdout=out, stderr=err, cwd=work, env=cli_env(),
                                pass_fds=(write_fd,))
    os.close(write_fd)
    reader = PipeReader(read_fd, run)
    reader.start()
    stop = threading.Event()
    try:
        keeper = None
        if not live:
            def keep_ahead():
                while not stop.is_set():
                    release_to(reader.count() + tr["ahead_frames"])
                    time.sleep(0.02)

            keeper = threading.Thread(target=keep_ahead, daemon=True)
            keeper.start()
        reader.wait_for(warm, FIRST_LINE_TIMEOUT_S, proc)
        run.t0 = run.lines[warm - 1][0]
        if live:
            for j in range(n_live):
                due = run.t0 + j / tr["rate_hz"]
                pause = due - time.perf_counter()
                if pause > 0:
                    time.sleep(pause)
                release_to(first + j + 1)
                now = time.perf_counter()
                run.due[first + j], run.late[first + j] = due, now - due
            run.t_end = time.perf_counter()
        else:
            pause = run.t0 + run.seconds - time.perf_counter()
            if pause > 0:
                time.sleep(pause)
            run.t_end = time.perf_counter()
            proc.send_signal(signal.SIGINT)
            stop.set()
            keeper.join()
        try:
            proc.wait(timeout=EXIT_TIMEOUT_S + (run.seconds if live else 0))
        except subprocess.TimeoutExpired:
            raise BenchError(f"the CLI did not exit within {EXIT_TIMEOUT_S} s of the window's end")
        run.t_exit = time.perf_counter()
        reader.join(timeout=30)
        run.lines = [(t, json.loads(raw)) for t, raw in run.lines]
    finally:
        stop.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    run.cli_stdout = out_path.read_text()
    if proc.returncode != 0:
        say(run.cli_stdout[-2000:])
        say(err_path.read_text()[-6000:])
        raise BenchError(f"the CLI exited {proc.returncode}")
    info["released"] = released
    return info


def window_quarters(run: Run) -> str:
    """Lines a second in each quarter of the window: a drift within the run
    shows here, a level that moves between runs does not."""
    q = run.seconds / 4
    counts = [0, 0, 0, 0]
    for t, _ in run.lines:
        if run.t0 < t <= run.t0 + run.seconds:
            counts[min(3, int((t - run.t0) / q))] += 1
    return " ".join(f"{c / q:.3f}" for c in counts)


def live_summary(run: Run) -> str:
    """Latency of the window's images: the sample, its quartiles, and the
    medians of its first and last thirds (a backlog that grows shows as the
    last third above the first)."""
    import numpy as np

    arrival = {int(p["file-number"]): t for t, p in run.lines}
    lat = np.array([arrival[i] - d for i, d in sorted(run.due.items()) if i in arrival]) * 1e3
    if not len(lat):
        return "latency: no sample"
    third = max(1, len(lat) // 3)
    q = np.percentile(lat, [25, 50, 75, 95])
    return (f"latency: {len(lat)} images, ms p25 {q[0]:.3f} p50 {q[1]:.3f} p75 {q[2]:.3f} "
            f"p95 {q[3]:.3f}; first third median {np.median(lat[:third]):.3f}, last third "
            f"median {np.median(lat[-third:]):.3f}")


def cli_report(run: Run) -> dict:
    for line in reversed(run.cli_stdout.strip().splitlines()):
        if line.startswith('{"ffsbench_cli"'):
            return json.loads(line)["ffsbench_cli"]
    raise BenchError("the CLI printed no report line")


def read_table(work: pathlib.Path) -> dict | None:
    """The spot table the CLI wrote (HDF5, or its columns as .npz)."""
    import numpy as np

    path = work / "results_ffs.h5"
    if pathlib.Path(str(path) + ".npz").exists():
        with np.load(str(path) + ".npz") as z:
            return {name: z[name] for name in z.files}
    if path.exists():
        import h5py

        with h5py.File(path, "r") as f:
            g = f["dials/processing/group_0"]
            return {name: g[name][()] for name in g}
    return None


def judge(run: Run, tmp: pathlib.Path, info: dict, control: str | None) -> tuple:
    """(correct, attempted, failed, checks)."""
    import numpy as np
    import torch

    from . import compare, reference
    from .frames import bench_device, checksums, detector_mask, make_frames

    cfg, tr = run.config, run.traffic
    k = tr["distinct_frames"]
    lines, dup = {}, 0
    for _, payload in run.lines:
        num = int(payload["file-number"])
        dup += num in lines
        lines[num] = payload
    if tr["arrival"] == "live":
        due = list(range(tr["warmup_frames"] + tr["ahead_frames"] + len(run.due)))
    else:  # catch-up: every image the CLI took in, in order from 0
        due = list(range(max(lines) + 1 if lines else 0))
    device = bench_device()
    frames = make_frames(cfg, tr, int(info["seed"]), device)
    if checksums(frames) != info["checksums"]:
        raise BenchError("the frames made again differ from the stream's")
    precision = cfg["spotfinder"]["precision"]
    mask = detector_mask(cfg["detector"])
    blobs = {n % k for n in due}
    ref = reference.frames_spots(frames, mask, cfg, precision, blobs)
    ctl = cfg["control"]
    low = np.dtype(ctl["tables"]).type
    if control == "reference":  # the reference one step below, in the program's place
        sub = reference.frames_spots(frames, mask, cfg, ctl["threshold"], blobs, low)
        lines = {n: {"file-number": n, "num_strong_pixels": len(sub[n % k].lin),
                     "n_spots_total": sub[n % k].n_spots,
                     "spot_centers": sub[n % k].centers.reshape(-1).tolist()} for n in due}
        dup = 0
    del frames
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = cfg["checks"]
    numbers, attempted, failed = compare.pipe_numbers(lines, due, dup, ref, k,
                                                      "centers" in checks)
    if "table" in checks:
        want = reference.rotation_table([ref[n % k] for n in due], cfg)
        if control == "reference":
            got = reference.rotation_table([sub[n % k] for n in due], cfg, low)
        else:
            got = read_table(tmp / "work")
            if got is None:
                raise BenchError("the CLI wrote no spot table")
        numbers.update(compare.table_numbers(got, want))
    ok, checked = compare.verdict(numbers, cfg["limits"])
    return ok, attempted, failed, checked


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ffsbench.run", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("program", "reference"), default=None)
    args = p.parse_args(argv)
    tmp = maker = None
    try:
        if not (ROOT / PROGRAM / "__init__.py").exists():
            raise BenchError(f"the program ({PROGRAM}) is not beside the benchmark in {ROOT}")
        manifest, workload, config_file, traffic_file = cell(args.workload)
        tmp = pathlib.Path(tempfile.mkdtemp(prefix="ffsbench-"))
        maker = start_stream(config_file, traffic_file, args.seed, tmp)
        device = card_info(workload["chips"])
        say(f"card: {power_limit()}; {device['kind']}")
        run = Run(workload, load_json(config_file), config_file, load_json(traffic_file),
                  args.seconds, T_START)
        info = drive(run, tmp, maker, bool(args.trace), args.control)
        info["seed"] = args.seed
        report = cli_report(run)
        if report["forbidden_modules"]:
            raise BenchError(f"the CLI process loaded {report['forbidden_modules']}")
        device["memory_peak_bytes"] = report["memory_peak_bytes"]
        run.cli_imported_unix = report["imported_unix"]
        if args.trace:
            path = tmp / "trace" / "trace.json"
            if not path.exists():
                raise BenchError("the traced run wrote no trace")
            say(f"trace: {path.stat().st_size} bytes")
            run.trace = tracing.read(path)
            path.unlink()
            device["busy_s"] = run.trace.busy_s
            device["window_s"] = run.trace.span_s
        waited = [ln for ln in run.cli_stdout.splitlines() if ln.startswith("Total time waiting")]
        say(f"lines: {run.frames}; released {info['released']}; window {run.seconds} s; "
            f"the CLI's wait line: {waited[0] if waited else 'none'}")
        say(f"timeline: CLI spawned at {run.t_spawn - T_START:.3f} s (its Python up "
            f"{report['started_unix'] - run.unix_spawn:.3f} s later, its imports done "
            f"{report['imported_unix'] - run.unix_spawn:.3f} s later), first line "
            f"{run.lines[0][0] - T_START:.3f} s ({run.lines[0][0] - run.t_spawn:.3f} s after "
            f"the spawn), window open {run.t0 - T_START:.3f} s, "
            f"intake end {run.t_end - T_START:.3f} s, pipe closed {run.t_eof - T_START:.3f} s, "
            f"CLI exit {run.t_exit - T_START:.3f} s")
        say(f"finish: {run.t_eof - run.t_end:.6f} s from the end of intake to the pipe's close; "
            f"rate by quarter of the window: {window_quarters(run)}")
        if run.late:
            lat = sorted(run.late.values())
            say(f"generator lateness: median {lat[len(lat) // 2] * 1e3:.3f} ms, "
                f"max {lat[-1] * 1e3:.3f} ms over {len(lat)} releases")
            say(live_summary(run))
        metrics = {}
        for m in cell_metrics(manifest, workload["name"], bool(args.trace)):
            value = read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        t_ref = time.perf_counter()
        correct, attempted, failed, checks = judge(run, tmp, info, args.control)
        say(f"reference and comparison: {time.perf_counter() - t_ref:.3f} s")
        found = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
        if found:
            raise BenchError(f"the harness process loaded {found}")
        result = {"correct": correct, "attempted": attempted, "failed": failed,
                  "metrics": metrics, "device": device}
        if args.trace:
            result["breakdown"] = {"device_ops": tracing.top_device_ops(run.trace),
                                   "idle_gaps": [[n, s] for n, s in run.trace.gaps]}
        result["checks"] = checks
    except BenchError as e:
        say(f"FAILED: {e}")
        return 1
    finally:
        if maker is not None and maker.poll() is None:
            maker.kill()
            maker.wait()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
