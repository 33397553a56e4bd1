"""Byte bounds of the batched path's kernels, and a kernel's share of its
bound read from a traced run: the compulsory bytes of a launch at the
card's HBM rate (``peaks.HBM_BYTES_PER_S``), over the kernel's mean device
time a launch.  A launch's frames are the CLI's ``--batch`` (a partial tail
batch is padded to it); the byte counts are the benchmark's own, from the
shapes."""

from __future__ import annotations

from .peaks import HBM_BYTES_PER_S, packed_word_lanes

DISPERSION_HALO = 3  # the dispersion window's reach: 7 x 7, radius 3


def threshold_bytes(batch: int, height: int, width: int, pixel_bytes: int) -> int:
    """``dispersion_walker``: the batch's frames and the uint8 mask read
    once, the (B, H, 2 * lanes) int32 [counts | words] output written once."""
    lanes = packed_word_lanes(width, DISPERSION_HALO)
    return batch * height * width * pixel_bytes + height * width + batch * height * 2 * lanes * 4


def decode_bytes(batch: int, height: int, width: int, pixel_bytes: int) -> int:
    """``bitshuffle_frames_kernel``: the bit planes read once, the frames
    written once, B x H x W pixels each way."""
    return 2 * batch * height * width * pixel_bytes


def share_pct(run, kernel: str, nbytes) -> float | None:
    """Percent of the byte bound that the launches of ``kernel`` (a part of
    their trace name) reach; None without a trace or a launch."""
    t = run.trace
    if t is None:
        return None
    times = [s for cat, name, s in t.device if cat == "kernel" and kernel in name]
    if not times:
        return None
    flags = run.config["spotfinder"]["cli_flags"]
    batch = int(flags[flags.index("--batch") + 1]) if "--batch" in flags else 1
    det = run.config["detector"]
    n = nbytes(batch, det["height"], det["width"], det["bit_depth"] // 8)
    return 100.0 * n / HBM_BYTES_PER_S / (sum(times) / len(times))
