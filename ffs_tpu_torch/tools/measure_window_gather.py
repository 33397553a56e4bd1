"""Window-gather layouts and probes on the card.

    python -m ffs_tpu_torch.tools.measure_window_gather   # FFS_BENCH_REPS=32

Counterpart of the JAX package's ``tools/measure_window_gather.py``, at its
shapes (A = 2048 windows, F = 4 frames, bh = 24 rows, 2164 x 2068 frames
padded to the gather contract, seed 7).  First the results are held equal
bit for bit, then each variant is timed over ``REPS`` launches whose input
depends on the loop counter (``frames + (i & 1)``) and whose output is
consumed:

- ``pf``: the plane-first gather (``window_gather_planes``);
- ``pl+transpose``: the plane-last gather paying the (F, Hp, Wp) ->
  (Hp, Wp/128, F, 128) transpose in every rep;
- ``pl_pre``: the plane-last gather on a pre-transposed source;
- ``probe_*``: the measurement probe (``make_probe_gather``): the
  single-block form (one aligned 128-column block a window row, rotated:
  the window itself only where x0 % 128 == 0), and the double form with
  ``r`` windows per block and ``slots``, the depth of each block's ring of
  shared-memory stages that TMA loads fill (up to ``slots - 1`` loads in
  flight a block while it writes one stage out; ``probe_plan`` says what
  a stage holds).  The ``probe_s{slots}_r{r}`` rows time the ring's depth;
  ``slots`` never changes the result;
- ``pf_packed``: the lane-packed gather (``window_gather_planes_packed``),
  a row the JAX tool lacks.

On a CUDA device the times come from CUDA events; with
``FFS_TORCH_DEVICE=cpu`` the host clock times PyTorch's CPU kernels.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from ..ops.window_gather import (
    pack_windows,
    window_gather_planes,
    window_gather_planes_packed,
    window_gather_planes_pl,
    window_gather_probe,
    window_gather_probe_plain,
)
from ..utils import torchinit

A = 2048
F = 4
BH = 24
H, W = 2164, 2068
SLOTS_R = ((4, 8), (8, 8), (4, 16), (16, 4))


def make_inputs(device: torch.device, *, a: int = A, f: int = F, bh: int = BH, h: int = H,
                w: int = W, seed: int = 7):
    """(F, Hp, Wp) int32 frames on ``device`` (values below 60000, the
    plane padded to the contract: Hp a multiple of 8 past h + bh, Wp a
    multiple of 128 with a spare block) and (A,) int32 host offsets."""
    rng = np.random.default_rng(seed)
    hp = ((h + bh + 7) // 8) * 8
    wp = ((w + 255) // 128) * 128
    frames = rng.integers(0, 60000, size=(f, hp, wp), dtype=np.uint16).astype(np.int32)
    y0 = rng.integers(0, h - bh, size=a, dtype=np.int32)
    x0 = rng.integers(0, w - 128, size=a, dtype=np.int32)
    return torch.from_numpy(frames).to(device), y0, x0


def to_pl(frames: torch.Tensor) -> torch.Tensor:
    """(F, Hp, Wp) -> plane-last (Hp, Wp/128, F, 128)."""
    f, hp, wp = frames.shape
    return frames.reshape(f, hp, wp // 128, 128).permute(1, 2, 0, 3).contiguous()


def make_probe_gather(single_only: bool, r: int = 8, slots: int = 2):
    """The probe with its knobs bound: ``gather(img, y0, x0, *, bh)``; ``r``
    windows a CUDA block, through a TMA ring of ``slots`` stages (the
    loads in flight, as the TPU probe's DMA lookahead ``slots - 1``)."""
    return functools.partial(window_gather_probe, single_only=single_only, r=r, slots=slots)


def check(frames: torch.Tensor, y0, x0, bh: int = BH) -> torch.Tensor:
    """Every variant against the plane-first gather, bit for bit (an
    AssertionError names the one that differs); returns the plane-first
    windows."""
    ref = window_gather_planes(frames, y0, x0, bh=bh)
    got = window_gather_planes_pl(to_pl(frames), y0, x0, bh=bh)
    assert torch.equal(ref, got), "plane-last gather mismatch"
    print("pf == pl: bitwise identical", flush=True)
    got = make_probe_gather(single_only=False)(frames, y0, x0, bh=bh)
    assert torch.equal(ref, got), "probe double-block gather mismatch"
    print("probe(double) == pf: bitwise identical", flush=True)
    got = make_probe_gather(single_only=True)(frames, y0, x0, bh=bh)
    want = window_gather_probe_plain(frames, y0, x0, bh=bh, single_only=True)
    assert torch.equal(want, got), "probe single mismatch"
    print("probe(single) == its rotated block: bitwise identical", flush=True)
    for ss, rr in SLOTS_R:
        got = make_probe_gather(single_only=False, r=rr, slots=ss)(frames, y0, x0, bh=bh)
        assert torch.equal(ref, got), f"slots={ss} r={rr} mismatch"
    print(f"probe slots/r cases {SLOTS_R} == pf: bitwise identical", flush=True)
    if len(y0) % 4 == 0:
        got = window_gather_planes_packed(frames, y0, x0, bh=bh)
        assert torch.equal(pack_windows(ref), got), "packed gather mismatch"
        print("packed == pf relaid out: bitwise identical", flush=True)
    return ref


def timeit(name: str, body, src: torch.Tensor, reps: int) -> float:
    """Milliseconds a rep of ``acc += body(src + (i & 1)).sum()`` after two
    untimed reps of the same statement, so that no kernel is first launched
    inside the timed loop (warm-up reps without the sum left the first row
    of a fresh process 3-4x slow on the H100); prints the row."""
    dev = src.device

    def rep(i, acc):
        return acc + body(src + (i & 1)).sum(dtype=torch.float64)

    acc = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(2):
        acc = rep(i, acc)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for i in range(reps):
        acc = rep(i, acc)
    if cuda:
        end.record()
        torch.cuda.synchronize(dev)
        dt = start.elapsed_time(end) / reps
    else:
        dt = (time.perf_counter() - t0) * 1e3 / reps
    float(acc)
    print(f"{name:14s} {dt:8.3f} ms/rep", flush=True)
    return dt


def run_rows(frames: torch.Tensor, y0, x0, bh: int, reps: int) -> dict[str, float]:
    """Time every variant; returns {row: ms a rep}."""
    dev = frames.device
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(f"device={torchinit.device_name(dev)} ({clock}) A={len(y0)} F={frames.shape[0]} "
          f"bh={bh} reps={reps}", flush=True)
    rows = {
        "pf": (lambda fr: window_gather_planes(fr, y0, x0, bh=bh), frames),
        "pl+transpose": (lambda fr: window_gather_planes_pl(to_pl(fr), y0, x0, bh=bh), frames),
        "pl_pre": (lambda fr: window_gather_planes_pl(fr, y0, x0, bh=bh), to_pl(frames)),
        "probe_double": (lambda fr: make_probe_gather(False)(fr, y0, x0, bh=bh), frames),
        "probe_single": (lambda fr: make_probe_gather(True)(fr, y0, x0, bh=bh), frames),
    }
    for rr in (4, 16):
        g = make_probe_gather(False, r=rr)
        rows[f"probe_r{rr}"] = (lambda fr, g=g: g(fr, y0, x0, bh=bh), frames)
    for ss, rr in SLOTS_R:
        g = make_probe_gather(False, r=rr, slots=ss)
        rows[f"probe_s{ss}_r{rr}"] = (lambda fr, g=g: g(fr, y0, x0, bh=bh), frames)
    if len(y0) % 4 == 0:
        rows["pf_packed"] = (lambda fr: window_gather_planes_packed(fr, y0, x0, bh=bh), frames)
    return {name: timeit(name, body, src, reps) for name, (body, src) in rows.items()}


def main(*, reps: int | None = None) -> dict[str, float]:
    """The tool at its shapes: the checks, then the timing rows."""
    reps = int(os.environ.get("FFS_BENCH_REPS", "32")) if reps is None else reps
    dev = torchinit.select_device()
    frames, y0, x0 = make_inputs(dev)
    check(frames, y0, x0, BH)
    return run_rows(frames, y0, x0, BH, reps)


if __name__ == "__main__":
    main()
