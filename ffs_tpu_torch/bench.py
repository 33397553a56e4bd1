"""The port's benchmark: Eiger 16M and Jungfrau 1M spotfinding, the Kabsch
integrator and SSX indexing on one NVIDIA GPU.

    python -m ffs_tpu_torch.bench

Counterpart of the repo's ``bench.py``, with the same six metric names,
bars and configurations.  The spotfinder step runs on the card end to end:
the packed dispersion threshold (``dispersion_packed_raw``, or
``dispersion_extended_packed_raw`` for Jungfrau) -> segmented batch
compaction with neighbour slots -> 2D connected components -> one
multi-frame float32 spot table -> filters.  The strong pixels and every
spot-table column of sample images 2 and 5 are held bit for bit against
``tests/data/bench_anchor_golden.npz`` (resident and through device decode)
before any rate is taken; then each stage times ``REPS`` steps whose inputs
alternate between two value-perturbed batches uploaded before the timed
window, with every output consumed into one scalar read once at the end.
The rate includes the step's own host synchronisations (the compaction's
``nonzero``, the labelling's round test).

Stages, each printing its metric line as soon as it is measured:

1. ``eiger16m_spotfind_fps``: B = 8 resident Eiger 16M frames (bar 500);
2. ``eiger16m_ingest_spotfind_fps``: the same frames as bitshuffle planes,
   decoded on the card (``frames_from_planes``) inside the loop (bar 500);
3. ``jungfrau1m_extended_spotfind_fps``: B = 112 Jungfrau 1M frames, the
   extended algorithm, 640 slots a frame, a 42-row gap band (bar 2500);
4. ``kabsch_integrate_refl_per_s`` and
   ``kabsch_integrate_effective_slices_per_s``
   (:mod:`.tools.bench_integrator`, bar 928,000);
5. ``ssx_index_images_per_s`` (:mod:`.tools.bench_ssx`, bar 100).

The last line re-emits the Eiger metric.  Every metric line carries
``"device"``, the card's name and power limit as nvidia-smi gives them;
before it, a line of each kernel wrapper's launches during the stage and a
torch.profiler window (device busy share, top kernels).  The first line
names the card, the torch and CUDA versions, the sizes and the reps.

Without a CUDA card the bench exits non-zero.  ``FFS_BENCH_SMOKE=1`` with
``FFS_TORCH_DEVICE=cpu`` runs toy shapes on the CPU, skips the anchors and
tags every line ``"smoke": true, "device": "cpu"``: a test of the control
flow, never a figure of the card.  An exception in a stage is printed, the
later stages still run, and the exit code is 1; so it is after a failed
anchor or capacity check, whose metric names then end in
``_VALIDATION_FAILED``.

``FFS_BENCH_BUDGET_S`` (2400 s) is a wall-clock budget: a stage that the
rest of it cannot cover is skipped with a note, and SIGTERM or an alarm at
the budget flushes what was measured (exit 0 if a metric was printed and
nothing failed).  The reps come from the environment under the repo
bench's names (:data:`REPS`); the sizes are its defaults (:data:`SIZES`).
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from .io import sample_data
from .ops import connected_components as cc
from .ops import kernel_wrappers
from .ops.compact import compact_from_pcw_segmented
from .ops.dispersion_extended_packed import dispersion_extended_packed_raw
from .ops.dispersion_packed import dispersion_packed_raw
from .utils import torchinit

GOLDEN = pathlib.Path(__file__).resolve().parent.parent / "tests" / "data" / "bench_anchor_golden.npz"
TRUSTED_MAX = 65535.0
MIN_SPOT_SIZE, MAX_SEPARATION = 3, 2.0  # bench.py's filter_spots(t, 3, 2.0)
VALIDATION_SLOTS = 16384  # per-frame capacity of the anchor step (image 2 holds 9506)
EIGER_BAR, JUNGFRAU_BAR = 500.0, 2500.0
JF_SHAPE, JF_GAP_ROWS = (1066, 1030), 42

# (full-size, smoke) values: bench.py's sizes, and the reps that bench.py
# reads from the environment under these names (a short run, as
# chip_smoke.py's phase 18, cuts them)
SIZES = {"batch": (8, 2), "max_px": (24576, 2048), "max_spots": (12288, 1024),
         "jf_batch": (112, 2), "int_refl": (2048, 64), "ssx_images": (64, 4), "ssx_batch": (64, 4)}
REPS = {"FFS_BENCH_REPS": (128, 2), "FFS_BENCH_INT_REPS": (16, 2),
        "FFS_BENCH_INT_EFF_SCALE": (1.0, 0.01), "FFS_BENCH_SSX_REPS": (2, 1)}
JF_SLOTS, JF_SPOTS = 640, 8192  # Jungfrau slots a frame (checked before timing), spots a table


def card_name(device: torch.device) -> str:
    """``name, power limit`` of the card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


class Run:
    """One bench run: its device, what it printed, whether anything failed.

    ``ok`` turns false on a failed anchor or capacity check (the metric
    names of the stages after it carry ``_VALIDATION_FAILED``, as in
    bench.py); ``errors`` counts stages that raised."""

    def __init__(self, device: torch.device, card: str, smoke: bool, budget_s: float = 2400.0):
        self.device = device
        self.card = card
        self.smoke = smoke
        self.budget_s = budget_s
        self.t0 = time.monotonic()
        self.printed = 0
        self.ok = True
        self.errors = 0
        self.rng = np.random.default_rng(12)  # bench.py's frame generator, shared in its order
        self.eiger_line = None

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def size(self, name: str):
        return SIZES[name][self.smoke]

    def reps(self, name: str):
        default = REPS[name][self.smoke]
        raw = os.environ.get(name, "")
        return type(default)(raw) if raw else default

    def remaining(self) -> float:
        return self.budget_s - (time.monotonic() - self.t0)

    def line(self, d: dict) -> None:
        d.setdefault("device", self.card)
        if self.smoke:
            d["smoke"] = True
        print(json.dumps(d), flush=True)

    def note(self, msg: str) -> None:
        print(f"bench[{time.monotonic() - self.t0:.0f}s]: {msg}", file=sys.stderr, flush=True)

    def fail_validation(self, msg: str) -> None:
        self.ok = False
        self.note(msg)

    def header(self) -> None:
        self.line({
            "bench": "ffs_tpu_torch",
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "sizes": {name: self.size(name) for name in SIZES},
            "reps": {name: self.reps(name) for name in REPS},
        })

    def counts(self) -> dict:
        return {name: fn.launches for name, fn in kernel_wrappers().items()}

    def emit(self, metric: str, value: float, unit: str, bar: float, *, since: dict | None = None,
             valid: bool = True) -> tuple:
        """Print a metric line now, after a line of the launches each kernel
        wrapper made since ``since``; returns the line's fields."""
        if since is not None:
            now = self.counts()
            self.line({"stage": metric, "launches": {k: now[k] - since[k] for k in now}})
        fields = (metric + ("" if valid else "_VALIDATION_FAILED"), value, unit, value / bar)
        self.emit_line(fields)
        return fields

    def emit_line(self, fields: tuple) -> None:
        metric, value, unit, vs = fields
        self.line({"metric": metric, "value": value, "unit": unit, "vs_baseline": vs})
        self.printed += 1

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def profile(self, stage: str, fn) -> None:
        """A torch.profiler window over ``fn()``: the device's busy share of
        the wall time and the five kernels or copies with the most device
        time (no device on the CPU: not measured)."""
        if not self.cuda:
            self.line({"profile": stage, "busy_share": None, "note": "not measured on the CPU"})
            return
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            self.sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted(
            ((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
             and not e.key.startswith("Activity Buffer")),
            reverse=True,
        )
        busy = sum(r[0] for r in rows)
        self.line({
            "profile": stage, "wall_ms": wall_ms, "device_busy_ms": busy,
            "busy_share": busy / wall_ms if rows else None,
            "top": [{"name": k[:80], "ms": ms, "count": n} for ms, n, k in rows[:5]],
        })

    def exit_code(self) -> int:
        return 0 if self.ok and not self.errors else 1

    def flush_and_exit(self, signum, frame) -> None:
        """SIGTERM or the budget's alarm: what was measured is on stdout
        already; exit 0 only if a metric got out and nothing failed."""
        self.note(f"terminated by signal {signum}; {self.printed} metric(s) already emitted")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0 if self.printed and not (self.errors or not self.ok) else 1)


def open_run(budget_s: float = 2400.0) -> Run:
    """The run's device: the CUDA card, or the CPU for the smoke alone
    (``FFS_BENCH_SMOKE=1`` with ``FFS_TORCH_DEVICE=cpu``).  Exits non-zero
    otherwise: no CPU run stands for the card."""
    smoke = os.environ.get("FFS_BENCH_SMOKE", "") not in ("", "0")
    want = os.environ.get(torchinit.DEVICE_ENV, "").strip().lower()
    torchinit.setup()
    if want == "cpu":
        if not smoke:
            raise SystemExit(
                f"bench: {torchinit.DEVICE_ENV}=cpu runs only the smoke (FFS_BENCH_SMOKE=1): "
                "the bench measures the card"
            )
        return Run(torch.device("cpu"), "cpu", smoke, budget_s)
    if not torch.cuda.is_available():
        raise SystemExit(
            "bench: no CUDA card (torch.cuda.is_available() is False); the bench measures an "
            f"NVIDIA GPU (FFS_BENCH_SMOKE=1 with {torchinit.DEVICE_ENV}=cpu runs its smoke)"
        )
    device = torchinit.select_device()
    return Run(device, card_name(device), smoke, budget_s)


# --- inputs ------------------------------------------------------------------


def make_frames(rng, h: int, w: int, n: int, mask: np.ndarray, n_spots: int = 300,
                amp: float = 60.0) -> np.ndarray:
    """Beamline-like (n, h, w) u16 frames: one Poisson(2) base, ``n_spots``
    3x3 spots of Poisson(``amp``) a frame, zero under the mask; bench.py's
    ``_make_frames``, the same frames for the same generator state."""
    base = rng.poisson(2.0, size=(h, w)).astype(np.uint16)
    frames = []
    for _ in range(n):
        f = base.copy()
        ys = rng.integers(8, h - 8, n_spots)
        xs = rng.integers(8, w - 8, n_spots)
        for yy, xx in zip(ys, xs):
            f[yy - 1 : yy + 2, xx - 1 : xx + 2] += rng.poisson(amp, size=(3, 3)).astype(np.uint16)
        f[mask == 0] = 0
        frames.append(f)
    return np.stack(frames)


def jungfrau_mask(h: int, w: int) -> np.ndarray:
    """All pixels valid but a 42-row module gap band across the middle."""
    mask = np.ones((h, w), dtype=np.uint8)
    mask[h // 2 : h // 2 + JF_GAP_ROWS] = 0
    return mask


def shifted(frames: np.ndarray, k: int) -> np.ndarray:
    """``frames + k`` wrapped modulo 2^16, as bench.py's u16 additions."""
    return (frames + np.uint16(k)).astype(np.uint16)


def to_planes(frames: np.ndarray) -> np.ndarray:
    """(B, n_blocks, block_bytes) u8 bitshuffle planes of u16 frames through
    the port's codec (compress, then the LZ4 half of the decode)."""
    from .io import compression

    out = []
    for f in frames:
        chunk = compression.bshuf_lz4_compress(f.reshape(-1), 2)
        planes, tail, _, n_shuf = compression.bshuf_lz4_planes(chunk, f.size, 2)
        if n_shuf != f.size or len(tail):
            raise ValueError("device decode needs a frame of whole 8-pixel groups")
        out.append(planes)
    return np.stack(out)


def flip_planes(planes: np.ndarray, d: int) -> np.ndarray:
    """bench.py's ingest perturbation ``iplanes ^ ppat * d`` on u8 planes:
    ``d`` XORed into the first 128 little-endian u32 words of each block,
    i.e. into bytes 4k, k < 128 (d < 4 touches the lowest bit planes)."""
    pat = np.zeros(planes.shape[-1], np.uint8)
    pat[: 4 * min(128, planes.shape[-1] // 4) : 4] = d
    return planes ^ pat


# --- the step ------------------------------------------------------------------


def full_step(batch: torch.Tensor, mask: torch.Tensor, per_frame_px: int, max_spots: int,
              extended: bool = False):
    """bench.py's all-device batch step on (B, H, W) frames: returns
    ``(pixels, table, keep, hp, counts)``.  The tall pitch is ``hp + 1``.
    bench.py's ``peak_key_slots`` is a TPU fast path with the same table,
    and its mask box count a TPU precomputation: the port takes neither."""
    threshold = dispersion_extended_packed_raw if extended else dispersion_packed_raw
    pcw = threshold(batch, mask, TRUSTED_MAX)
    hp = pcw.shape[1]
    w = batch.shape[-1]
    p, nbu, nbd, counts = compact_from_pcw_segmented(
        batch, pcw, max_pixels_per_frame=per_frame_px, with_neighbors=True
    )
    # an overflowing frame's neighbour slots may point past the array: clamp
    # them as JAX's gather does (the capacity checks fail such a run)
    k = p.linear_index.shape[0]
    root = cc.label_compact_pixels(p, width=w, neighbors=(nbu.clamp(max=k - 1), nbd.clamp(max=k - 1)))
    t = cc.spot_table_from_pixels(p, root, width=w, max_spots=max_spots, dtype=torch.float32,
                                  frame_rows=hp)
    # float32 separation test: bench.py runs without x64
    keep, _, _ = cc.filter_spots(t, MIN_SPOT_SIZE, MAX_SEPARATION, dtype=torch.float32)
    return p, t, keep, hp, counts


def consume_all(p, t, keep, counts) -> torch.Tensor:
    """Every spot-table column, the filter mask, the counts and the
    capacities summed into one float32 scalar (bench.py's ``consume_all``)."""
    acc = (p.count + counts.max() + t.n_spots + keep.sum(dtype=torch.int32)).to(torch.float32)
    for col in t[1:]:
        acc = acc + col.to(torch.float32).sum()
    return acc


def timed_rate(run: Run, consume, warm: tuple, timed: tuple, reps: int, frames: int) -> float:
    """Frames/s of ``reps`` calls of ``consume`` on the two timed inputs in
    turn (``i & 1``), after two calls on the two warm inputs; the sum of
    the outputs is read once, at the end of the window."""

    def chained(inputs, n):
        acc = torch.zeros((), dtype=torch.float32, device=run.device)
        for i in range(n):
            acc = acc + consume(inputs[i & 1])
        return float(acc)

    chained(warm, 2)
    t0 = time.perf_counter()
    chained(timed, reps)
    return frames * reps / (time.perf_counter() - t0)


def spotfind_rate(run: Run, metric: str, unit: str, bar: float, *, step, capacity: int,
                  others: list, warm: tuple, timed: tuple, n_frames: int, since: dict,
                  ok: bool) -> tuple:
    """One spotfinder stage's checks, rate, profile window and lines.

    ``step`` maps an input to :func:`full_step`'s outputs; ``warm`` and
    ``timed`` are the two input pairs the loop alternates, ``others`` the
    further inputs bench.py's capacity check covers.  A frame past
    ``capacity`` slots in any of them fails the run (the step's clamp would
    otherwise hide it)."""
    inputs = {id(x): x for x in (*others, *warm, *timed)}.values()
    worst = max(int(step(x)[4].max()) for x in inputs)
    if worst > capacity:
        ok = False
        run.fail_validation(f"{metric}: frames exceed the per-frame capacity: {worst} > {capacity}")

    def consume(x):
        p, t, keep, _, counts = step(x)
        return consume_all(p, t, keep, counts)

    fps = timed_rate(run, consume, warm, timed, run.reps("FFS_BENCH_REPS"), n_frames)
    run.profile(metric, lambda: [consume(timed[i & 1]) for i in range(2)])
    return run.emit(metric, fps, unit, bar, since=since, valid=ok)


# --- the anchor golden ----------------------------------------------------------


def load_anchor_golden():
    """The float64 host-oracle golden of sample images 2 and 5
    (``tests/data/bench_anchor_golden.npz``)."""
    return np.load(GOLDEN)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_anchor(golden, tag: str, w: int, lin, inten, table, *, frame: int = 0,
                 pitch: int = 0) -> list[str]:
    """One frame's strong pixels and spot table against the golden; the
    mismatches as strings (none: bit-parity).

    ``lin``, ``inten``: the frame's pixel list, linear indices tall at
    ``pitch`` rows a frame (``(frame * pitch + y) * w + x``; 0 for a single
    frame).  ``table``: a host table of this frame (``cc2d``, with
    ``peak_intensity``) or a multi-frame device ``SpotTable``, whose rows
    with ``z_min == frame`` are this frame's and whose peak intensity is
    read from the pixel list at the peak.  Integer data (coordinates,
    intensities, pixel counts, boxes, peaks and their intensity, the
    integer-valued intensity sums) must be equal; the centres of mass are
    float32 quotients of exact sums, held to a relative band of 1e-5 of
    the float64 golden; a device table's ``com_z`` must be frame + 0.5."""
    lin = _host(lin).astype(np.int64)
    inten = _host(inten).astype(np.int64)
    g_y = golden[f"{tag}_y"]
    if len(lin) != len(g_y):
        return [f"{tag}: pixel count {len(lin)} != {len(g_y)}"]
    y, x = lin // w - frame * pitch, lin % w
    errs = []
    if not (np.array_equal(y, g_y) and np.array_equal(x, golden[f"{tag}_x"])):
        errs.append(f"{tag}: strong-pixel coordinate list differs")
    if not np.array_equal(inten, golden[f"{tag}_intensity"].astype(np.int64)):
        errs.append(f"{tag}: strong-pixel intensities differ")

    device_table = hasattr(table, "valid")
    if device_table:
        sel = _host(table.valid) & (_host(table.z_min) == frame)
        n = int(sel.sum())
    else:
        n = table.n_spots
        sel = slice(0, n)
    n_g = len(golden[f"{tag}_n_pixels"])
    if n != n_g:
        return errs + [f"{tag}: spot count {n} != {n_g}"]

    def col(name):
        return _host(getattr(table, name))[sel]

    for name in ("n_pixels", "x_min", "x_max", "y_min", "y_max", "peak_x", "peak_y"):
        if not np.array_equal(col(name).astype(np.int64), golden[f"{tag}_{name}"].astype(np.int64)):
            errs.append(f"{tag}: column {name} differs")
    if device_table:  # the pixel list's intensity at each peak
        peak = (col("peak_y").astype(np.int64) + frame * pitch) * w + col("peak_x")
        at = np.clip(np.searchsorted(lin, peak), 0, max(len(lin) - 1, 0))
        peak_i = np.where(lin[at] == peak, inten[at], -1) if len(lin) else np.full(n, -1)
    else:
        peak_i = col("peak_intensity").astype(np.int64)
    if not np.array_equal(peak_i, golden[f"{tag}_peak_intensity"].astype(np.int64)):
        errs.append(f"{tag}: column peak_intensity differs")
    if not np.array_equal(col("sum_intensity").astype(np.float64),
                          golden[f"{tag}_sum_intensity"].astype(np.float64)):
        errs.append(f"{tag}: column sum_intensity differs")
    for name in ("com_x", "com_y"):
        if not np.allclose(col(name).astype(np.float64), golden[f"{tag}_{name}"].astype(np.float64),
                           rtol=1e-5, atol=1e-4):
            errs.append(f"{tag}: column {name} outside the float32 band")
    if device_table and not np.allclose(col("com_z"), frame + 0.5, rtol=0, atol=1e-6):
        errs.append(f"{tag}: column com_z != frame + 0.5")
    return errs


def sample_anchor_errors(batch: torch.Tensor, mask: torch.Tensor, golden):
    """Sample images 2 and 5 as frames 0 and 1 of ``batch`` through the
    step (16384 slots a frame) against the golden; returns the mismatches
    and frame 0's pixel list (lin, inten)."""
    p, t, _, hp, counts = full_step(batch, mask, VALIDATION_SLOTS, VALIDATION_SLOTS)
    lin, inten, counts = _host(p.linear_index), _host(p.intensity), _host(counts)
    w = batch.shape[-1]
    errs, lists = [], []
    for frame, tag in enumerate(("img2", "img5")):
        lo = frame * VALIDATION_SLOTS
        seg = slice(lo, lo + min(int(counts[frame]), VALIDATION_SLOTS))
        errs += check_anchor(golden, tag, w, lin[seg], inten[seg], t, frame=frame, pitch=hp + 1)
        lists.append((lin[seg], inten[seg]))
    return errs, lists[0]


def sample_pair() -> np.ndarray:
    return np.stack([sample_data.generate_sample_image(2), sample_data.generate_sample_image(5)])


# --- stages --------------------------------------------------------------------


def eiger_shape(run: Run) -> tuple[int, int, np.ndarray]:
    if run.smoke:
        return 256, 256, np.ones((256, 256), dtype=np.uint8)
    mask = sample_data.generate_mask()
    return *mask.shape, mask


def stage_eiger(run: Run, frames: np.ndarray) -> None:
    """Anchors, then the resident Eiger 16M batch's frames/s."""
    since = run.counts()
    h, w, mask_np = eiger_shape(run)
    mask = torch.from_numpy(mask_np).to(run.device)
    if not run.smoke:
        from .ops.cc2d_host import cc2d

        errs, (lin0, int0) = sample_anchor_errors(
            torch.from_numpy(sample_pair()).to(run.device), mask, load_anchor_golden()
        )
        # the CLI's host CC on the same pixels (frame 0's tall indices are its own)
        n_host = cc2d(lin0.astype(np.int64), int0, w).n_spots
        if n_host != 9506:
            errs.append(f"host CC: {n_host} spots on image 2 != 9506")
        run.line({"anchors": "resident", "ok": not errs, "errors": errs})
        if errs:
            run.fail_validation("ANCHOR BIT-PARITY FAILED: " + "; ".join(errs))
    kf = run.size("max_px") // len(frames)
    s = run.size("max_spots")

    def upload(k):
        return torch.from_numpy(shifted(frames, k)).to(run.device)

    b2, b3, b4 = upload(2), upload(3), upload(4)
    run.eiger_line = spotfind_rate(
        run, "eiger16m_spotfind_fps", "frames/s/chip", EIGER_BAR,
        step=lambda b: full_step(b, mask, kf, s), capacity=kf, others=[upload(0), upload(5)],
        warm=(b2, b3), timed=(b3, b4), n_frames=len(frames), since=since, ok=run.ok,
    )


def stage_ingest(run: Run, frames: np.ndarray) -> None:
    """The Eiger batch as bitshuffle planes: device decode, then the step,
    in the loop; the anchors through the same decode first."""
    from .ops.bitshuffle_device import frames_from_planes

    since = run.counts()
    h, w, mask_np = eiger_shape(run)
    mask = torch.from_numpy(mask_np).to(run.device)
    kf = run.size("max_px") // len(frames)
    s = run.size("max_spots")
    ok = run.ok

    def decode(planes):
        return frames_from_planes(planes, h, w, torch.uint16)

    if not run.smoke:
        planes = torch.from_numpy(to_planes(sample_pair())).to(run.device)
        errs, _ = sample_anchor_errors(decode(planes), mask, load_anchor_golden())
        run.line({"anchors": "ingest", "ok": not errs, "errors": errs})
        if errs:
            ok = False
            run.fail_validation("INGEST ANCHOR BIT-PARITY FAILED: " + "; ".join(errs))

    planes = to_planes(frames)

    def upload(d):
        return torch.from_numpy(flip_planes(planes, d)).to(run.device)

    p2, p3 = upload(2), upload(3)
    # bench.py's loop XORs (i & 1) into the planes it is given: from P^2,
    # P^2 then P^3; from P^3, P^3 then P^2
    spotfind_rate(
        run, "eiger16m_ingest_spotfind_fps",
        "frames/s/chip (bitshuffle-plane input; device decode in-loop)", EIGER_BAR,
        step=lambda pl: full_step(decode(pl), mask, kf, s), capacity=kf,
        others=[upload(0), upload(1)], warm=(p2, p3), timed=(p3, p2), n_frames=len(frames),
        since=since, ok=ok,
    )


def stage_jungfrau(run: Run, frames: np.ndarray) -> None:
    """B = 112 Jungfrau 1M frames through the extended step."""
    since = run.counts()
    h, w = frames.shape[1:]
    mask = torch.from_numpy(jungfrau_mask(h, w)).to(run.device)
    kf, s = JF_SLOTS, JF_SPOTS

    def upload(k):
        return torch.from_numpy(shifted(frames, k)).to(run.device)

    b2, b3, b4 = upload(2), upload(3), upload(4)
    spotfind_rate(
        run, "jungfrau1m_extended_spotfind_fps", "frames/s/chip", JUNGFRAU_BAR,
        step=lambda b: full_step(b, mask, kf, s, extended=True), capacity=kf,
        others=[upload(0), upload(5)], warm=(b2, b3), timed=(b3, b4), n_frames=len(frames),
        since=since, ok=run.ok,
    )


def guarded(run: Run, name: str, fn, *args) -> None:
    """Run one stage; an exception is printed and counted, and the next
    stage runs."""
    try:
        fn(run, *args)
    except Exception:  # a stage's failure must not starve the later metrics
        run.errors += 1
        traceback.print_exc()
        run.note(f"{name} stage FAILED")


def main() -> int:
    run = open_run(float(os.environ.get("FFS_BENCH_BUDGET_S", "2400")))
    signal.signal(signal.SIGTERM, run.flush_and_exit)
    signal.signal(signal.SIGALRM, run.flush_and_exit)
    # last resort past the budget: the stage guards skip first; the alarm
    # fires only if a stage hangs past the guard that admitted it
    signal.alarm(int(run.budget_s) + 60)
    run.header()

    h, w, mask = eiger_shape(run)
    eiger = make_frames(run.rng, h, w, run.size("batch"), mask,
                        n_spots=20 if run.smoke else 300)
    guarded(run, "eiger", stage_eiger, eiger)
    if run.remaining() < 300.0:
        run.note(f"skipping the ingest metric: {run.remaining():.0f} s of the budget left")
    else:
        guarded(run, "ingest", stage_ingest, eiger)
    if run.remaining() < 120.0:
        run.note(f"skipping the Jungfrau metric: {run.remaining():.0f} s of the budget left")
    else:
        jh, jw = (256, 256) if run.smoke else JF_SHAPE
        jf = make_frames(run.rng, jh, jw, run.size("jf_batch"), jungfrau_mask(jh, jw),
                         n_spots=60)
        guarded(run, "jungfrau", stage_jungfrau, jf)
    from .tools import bench_integrator, bench_ssx

    for name, stage in (("integrator", bench_integrator.run_stage), ("ssx", bench_ssx.run_stage)):
        if run.remaining() < 90.0:
            run.note(f"skipping the {name} metric: {run.remaining():.0f} s of the budget left")
        else:
            guarded(run, name, stage)

    # the last line re-emits the headline Eiger metric
    if run.eiger_line is not None:
        run.emit_line(run.eiger_line)
    signal.alarm(0)
    return run.exit_code()


if __name__ == "__main__":
    sys.exit(main())
