"""Per-stage timing of the spotfind measurement path on the card.

    python -m ffs_tpu_torch.tools.measure_stages           # B=8, REPS=10
    PACKED=1 python -m ffs_tpu_torch.tools.measure_stages  # packed-words rows

Counterpart of the JAX package's ``tools/measure_stages.py``.  It builds
the same synthetic Eiger 16M batch (seed 12: a Poisson(2) base, 300 3x3
spots of Poisson(60) per frame, the sample module mask, ``B`` frames), then
times nested prefixes of the pipeline over ``REPS`` launches: the rowcum
threshold (``dispersion_fused``, no strong plane); + per-frame compaction;
+ connected components; + spot table and filters; the flat-batch
compaction; the flat-batch pipeline.  ``PACKED=1`` runs the packed-words
rows instead (``dispersion_packed`` + ``compact_from_words_flat``).  One
row the JAX tool lacks times the extended threshold's rowcum entry.  Unlike
the JAX tool it builds no mask box count: the kernels count the window from
the mask.  Differences between successive rows are per-stage costs.

Every row's input depends on the loop counter (``b + (i & 1)``) and every
output is consumed into the row's checksum.  On a CUDA device the times
come from CUDA events around the ``REPS`` launches; with
``FFS_TORCH_DEVICE=cpu`` it runs on the host CPU on the host clock, which
measures PyTorch's CPU kernels and no device.  The stage functions take
``(i, batch, ctx)`` and return ``(checksum, outputs)``, so a test can call
them at a small size and hold the outputs against the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..bench import make_frames
from ..io import sample_data
from ..ops import connected_components as cc
from ..ops.compact import (
    compact_from_rowcum,
    compact_from_rowcum_flat,
    compact_from_words_flat,
)
from ..ops.dispersion_extended_packed import (
    dispersion_extended_fused,
    dispersion_extended_fused_plain,
)
from ..ops.dispersion_packed import (
    dispersion_fused,
    dispersion_fused_plain,
    dispersion_packed,
    dispersion_packed_plain,
)
from ..utils import torchinit

TM = 65535.0
MAX_PX = 8192
MAX_SPOTS = 4096
FLAT_PX = 24576
FLAT_SPOTS = 12288


def make_batch(batch: int, mask: np.ndarray, *, spots: int = 300, seed: int = 12) -> np.ndarray:
    """(batch, *mask.shape) u16 frames: one Poisson(2) base, ``spots`` 3x3 spots of
    Poisson(60) added per frame at 8 px or more from the edges, zero under
    the mask; the JAX tool's batch for the same seed and shape."""
    return make_frames(np.random.default_rng(seed), *mask.shape, batch, mask, n_spots=spots)


@dataclasses.dataclass
class StageContext:
    """What the stages share: the mask on the device, the capacities, and
    ``plain`` (the thresholds' plain PyTorch versions in place of their
    kernels, for a reference run on the same device)."""

    mask: torch.Tensor
    max_px: int = MAX_PX
    max_spots: int = MAX_SPOTS
    flat_px: int = FLAT_PX
    flat_spots: int = FLAT_SPOTS
    plain: bool = False

    @classmethod
    def build(cls, mask: np.ndarray, device: torch.device | None = None, **kw) -> StageContext:
        dev = torchinit.select_device() if device is None else device
        m = torch.from_numpy(np.ascontiguousarray(mask, np.uint8)).to(dev)
        return cls(mask=m, **kw)

    @property
    def width(self) -> int:
        return self.mask.shape[-1]

    @property
    def height(self) -> int:
        return self.mask.shape[-2]


def vary(i: int, b: torch.Tensor) -> torch.Tensor:
    """``b + (i & 1)`` for u16 frames, through a same-width signed view
    (PyTorch's uint16 lacks arithmetic on the card); wraps as u16 does."""
    return (b.view(torch.int16) + (i & 1)).view(torch.uint16)


def _rowcum(ctx: StageContext, bb: torch.Tensor) -> torch.Tensor:
    if ctx.plain:
        return dispersion_fused_plain(bb, ctx.mask, TM, emit_strong=False)[1]
    return dispersion_fused(bb, ctx.mask, TM, emit_strong=False)[1]


def _words(ctx: StageContext, bb: torch.Tensor):
    if ctx.plain:
        pcw = dispersion_packed_plain(bb, ctx.mask, TM)
        nwl = pcw.shape[-1] // 2
        return pcw[..., nwl:], pcw[..., :nwl]
    return dispersion_packed(bb, ctx.mask, TM)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _table(ctx: StageContext, p, max_spots: int, frame_rows: int | None = None):
    """Labels, float32 spot table and filters, as the JAX tool (x64 off)."""
    root = cc.label_compact_pixels(p, width=ctx.width)
    t = cc.spot_table_from_pixels(p, root, width=ctx.width, max_spots=max_spots,
                                  dtype=torch.float32, frame_rows=frame_rows)
    keep, _, _ = cc.filter_spots(t, 3, 2.0, dtype=torch.float32)
    return root, t, keep


def _table_sum(p, t, keep) -> torch.Tensor:
    return (p.count + t.n_spots + keep.sum() + t.com_x.sum() + t.com_y.sum()).to(torch.float32)


def k_only(i: int, b: torch.Tensor, ctx: StageContext):
    """The rowcum threshold alone (row totals consumed)."""
    rowcum = _rowcum(ctx, vary(i, b))
    return _f32(rowcum[:, :, -1].sum()), (rowcum,)


def ext_only(i: int, b: torch.Tensor, ctx: StageContext):
    """The extended threshold's rowcum entry alone (row totals consumed)."""
    bb = vary(i, b)
    fused = dispersion_extended_fused_plain if ctx.plain else dispersion_extended_fused
    _, rowcum = fused(bb, ctx.mask, TM, emit_strong=False)
    return _f32(rowcum[:, :, -1].sum()), (rowcum,)


def k_compact(i: int, b: torch.Tensor, ctx: StageContext):
    """+ per-frame compaction."""
    bb = vary(i, b)
    rowcum = _rowcum(ctx, bb)
    total, outs = 0, []
    for image, rc in zip(bb, rowcum):
        p = compact_from_rowcum(image, rc, max_pixels=ctx.max_px)
        total = total + (p.linear_index % 97).sum() + p.intensity.sum() + p.count
        outs.append(p)
    return _f32(total), outs


def k_cc(i: int, b: torch.Tensor, ctx: StageContext):
    """+ connected components."""
    bb = vary(i, b)
    rowcum = _rowcum(ctx, bb)
    total, outs = 0, []
    for image, rc in zip(bb, rowcum):
        p = compact_from_rowcum(image, rc, max_pixels=ctx.max_px)
        root = cc.label_compact_pixels(p, width=ctx.width)
        total = total + root.sum() + p.intensity.sum() + p.count
        outs.append((p, root))
    return _f32(total), outs


def k_full(i: int, b: torch.Tensor, ctx: StageContext):
    """+ spot table and filters: the per-frame pipeline."""
    bb = vary(i, b)
    rowcum = _rowcum(ctx, bb)
    total, outs = 0, []
    for image, rc in zip(bb, rowcum):
        p = compact_from_rowcum(image, rc, max_pixels=ctx.max_px)
        root, t, keep = _table(ctx, p, ctx.max_spots)
        total = total + _table_sum(p, t, keep)
        outs.append((p, root, t, keep))
    return _f32(total), outs


def flat_compact(i: int, b: torch.Tensor, ctx: StageContext):
    """The threshold + one flat-batch compaction."""
    bb = vary(i, b)
    p = compact_from_rowcum_flat(bb, _rowcum(ctx, bb), max_pixels_total=ctx.flat_px)
    return _f32((p.linear_index % 97).sum() + p.intensity.sum() + p.count), (p,)


def flat_full(i: int, b: torch.Tensor, ctx: StageContext):
    """The flat-batch pipeline: one pixel list and one spot table a batch."""
    bb = vary(i, b)
    p = compact_from_rowcum_flat(bb, _rowcum(ctx, bb), max_pixels_total=ctx.flat_px)
    root, t, keep = _table(ctx, p, ctx.flat_spots, frame_rows=ctx.height)
    return _table_sum(p, t, keep), (p, root, t, keep)


def pk_only(i: int, b: torch.Tensor, ctx: StageContext):
    """The packed threshold alone (row totals and one word row consumed)."""
    w32, pc = _words(ctx, vary(i, b))
    return _f32(pc[:, :, -1].sum() + w32[0, 0].sum()), (w32, pc)


def pk_compact(i: int, b: torch.Tensor, ctx: StageContext):
    """The packed threshold + the words' flat compaction."""
    bb = vary(i, b)
    w32, pc = _words(ctx, bb)
    p = compact_from_words_flat(bb, w32, pc, max_pixels_total=ctx.flat_px)
    return _f32((p.linear_index % 97).sum() + p.intensity.sum() + p.count), (p,)


def pk_full(i: int, b: torch.Tensor, ctx: StageContext):
    """The packed flat-batch pipeline."""
    bb = vary(i, b)
    w32, pc = _words(ctx, bb)
    p = compact_from_words_flat(bb, w32, pc, max_pixels_total=ctx.flat_px)
    root, t, keep = _table(ctx, p, ctx.flat_spots, frame_rows=ctx.height)
    return _table_sum(p, t, keep), (p, root, t, keep)


MAIN_ROWS = [
    ("kernel only (rowcum consumed)", k_only),
    ("kernel + compact (per frame)", k_compact),
    ("kernel + compact + CC (per frame)", k_cc),
    ("kernel + compact + CC + table (per frame)", k_full),
    ("kernel + flat compact", flat_compact),
    ("kernel + flat compact + CC + table", flat_full),
    ("extended kernel only (rowcum consumed)", ext_only),
]
PACKED_ROWS = [
    ("packed kernel only", pk_only),
    ("packed kernel + words-flat compact", pk_compact),
    ("packed kernel + compact + CC + table (flat)", pk_full),
]


def timeit(name: str, fn, batch: torch.Tensor, ctx: StageContext, reps: int) -> float:
    """Milliseconds a batch of ``fn`` over ``reps`` loop-dependent launches,
    after two untimed reps of the same statement (checksum included, so no
    kernel is first launched inside the timed loop); prints the row."""
    dev = batch.device
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(2):
        acc = acc + fn(i, batch, ctx)[0]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for i in range(reps):
        acc = acc + fn(i, batch, ctx)[0]
    if cuda:
        end.record()
        torch.cuda.synchronize(dev)
        dt = start.elapsed_time(end) / reps
    else:
        dt = (time.perf_counter() - t0) * 1e3 / reps
    float(acc)  # every rep's checksum consumed
    b = batch.shape[0]
    print(f"{name:58s} {dt:9.3f} ms/batch  {dt / b:8.3f} ms/frame", flush=True)
    return dt


def run_rows(ctx: StageContext, batch: torch.Tensor, rows, reps: int) -> dict[str, float]:
    """Time each (name, stage) row; returns {name: ms a batch}."""
    dev = batch.device
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(f"device={torchinit.device_name(dev)} ({clock}) B={batch.shape[0]} reps={reps}",
          flush=True)
    return {name: timeit(name, fn, batch, ctx, reps) for name, fn in rows}


def main(*, reps: int | None = None, packed: bool | None = None) -> dict[str, float]:
    """The tool: the batch size from ``B``, and ``REPS`` and ``PACKED``
    from the environment unless given."""
    reps = int(os.environ.get("REPS", "10")) if reps is None else reps
    packed = bool(os.environ.get("PACKED")) if packed is None else packed
    dev = torchinit.select_device()
    torchinit.setup()
    mask = sample_data.generate_mask()
    frames = make_batch(int(os.environ.get("B", "8")), mask)
    ctx = StageContext.build(mask, dev)
    print("packed-words path" if packed else "rowcum path", flush=True)
    return run_rows(ctx, torch.from_numpy(frames).to(dev), PACKED_ROWS if packed else MAIN_ROWS,
                    reps)


if __name__ == "__main__":
    main()
