"""Shoebox window gathers: CUDA kernels and plain versions.

Counterparts of :func:`ffs_tpu.ops.window_gather.window_gather_planes` and
:func:`ffs_tpu.ops.window_gather.window_gather`, the integrator's gathers of
fixed-size windows at per-reflection offsets:

    window_gather_planes(img, y0, x0, bh=bh)[a, p, r, c] = img[p, y0[a]+r, x0[a]+c]
    window_gather(img, y0, x0, bh=bh)[a, r, c]           = img[y0[a]+r, x0[a]+c]

for r < bh and c < 128; callers slice the columns they need.  ``img`` is
int32 or float32 (the TPU contract's >= 32-bit inputs; the output keeps the
input's type) and ``y0``/``x0`` are host arrays.  The contract is checked on
the host before anything runs, and a breach raises: ``Wp % 128 == 0``,
``Wp >= 256``, ``bh % 8 == 0``, ``0 <= x0 < Wp - 128`` (the TPU kernel's
strict bound) and ``0 <= y0``, ``y0 + bh <= Hp``.

Each wrapper picks by the image tensor's device: a CPU tensor takes the
plain PyTorch version (one advanced-indexing expression), a CUDA tensor
launches the kernel in ``csrc/window_gather.cu`` or raises; there is no
fallback between the two.  ``.launches`` on each wrapper counts its kernel
launches.

The TPU's gather variants have their counterparts here too, each with its
own kernel, plain version and counter, under the same contract checks:

* :func:`window_gather_planes_packed` (``_gather_planes_packed_kernel``):
  (A/4, P, bh, 128), lanes 32g..32g+31 of row i = columns 0..31 of window
  4i+g, i.e. ``window_gather_planes(...)[..., :32]`` relaid out; A % 4 == 0;
* :func:`window_gather_planes_pl` (``_gather_planes_pl_kernel``): the same
  windows as :func:`window_gather_planes` from a plane-last (Hp, Wp/128, P,
  128) source;
* :func:`window_gather_probe` (the kernel of ``make_probe_gather`` in
  ``tools/measure_window_gather.py``): the plane-first gather with ``r``
  windows per block, or with ``single_only`` the one-block rotate
  ``img[q, y0+r, 128*xblk + (c + shift) % 128]``, xblk = min(x0 // 128,
  Wp/128 - 2), shift = x0 - 128*xblk, the TPU probe's result.  Its kernel
  loads through TMA into a ring of ``slots`` shared-memory stages, which
  :func:`probe_plan` sizes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LANES = 128
DTYPES = (torch.int32, torch.float32)


def _check(img: torch.Tensor, y0, x0, bh: int, planes: bool):
    """Validate a gather's arguments against the contract; returns the host
    offsets as int64 arrays."""
    if img.dim() != (3 if planes else 2):
        want = "(P, Hp, Wp)" if planes else "(Hp, Wp)"
        raise ValueError(f"image must be {want}, got {tuple(img.shape)}")
    return _check_windows(img.dtype, *img.shape[-2:], y0, x0, bh)


def _check_windows(dtype: torch.dtype, hp: int, wp: int, y0, x0, bh: int):
    """The contract on a (Hp, Wp) plane's type, width and window offsets."""
    if dtype not in DTYPES:
        raise TypeError(f"window gathers take int32 or float32 images, got {dtype}")
    if wp % LANES or wp < 2 * LANES:
        raise ValueError(f"image width {wp} must be a multiple of 128 and >= 256; pad the image")
    if bh <= 0 or bh % 8:
        raise ValueError(f"bh={bh} must be a positive multiple of 8")
    y0, x0 = np.asarray(y0, np.int64), np.asarray(x0, np.int64)
    if y0.ndim != 1 or y0.shape != x0.shape:
        raise ValueError(f"y0 {y0.shape} and x0 {x0.shape} must be equal 1-D shapes")
    if len(y0):
        if x0.min() < 0 or x0.max() >= wp - LANES:
            raise ValueError(
                f"x0 in [{x0.min()}, {x0.max()}] breaks 0 <= x0 < Wp-128 = {wp - LANES}"
            )
        if y0.min() < 0 or y0.max() + bh > hp:
            raise ValueError(
                f"y0 in [{y0.min()}, {y0.max()}] breaks 0 <= y0, y0+bh <= Hp = {hp}"
            )
    return y0, x0


def window_index(y0: np.ndarray, x0: np.ndarray, bh: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(A, bh, 128) row and column indices of the windows."""
    rows = torch.as_tensor(y0, device=device)[:, None, None] + torch.arange(bh, device=device)[:, None]
    cols = torch.as_tensor(x0, device=device)[:, None, None] + torch.arange(LANES, device=device)
    return rows, cols


def window_gather_planes_plain(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`window_gather_planes`, on any
    device."""
    y0, x0 = _check(img, y0, x0, bh, planes=True)
    rows, cols = window_index(y0, x0, bh, img.device)
    return img[:, rows, cols].permute(1, 0, 2, 3).contiguous()


def window_gather_plain(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`window_gather`, on any device."""
    y0, x0 = _check(img, y0, x0, bh, planes=False)
    rows, cols = window_index(y0, x0, bh, img.device)
    return img[rows, cols]


def _launch(entry: str, img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, bh: int,
            out: torch.Tensor, shape=None, extra=()) -> None:
    """Launch ``entry`` on ``img``'s card and its current stream: ``img``
    contiguous on the card, ``y0``/``x0`` (A,) int32 on the same card,
    ``out`` allocated; ``shape`` the image dimensions the entry takes
    (default all of them), ``extra`` its int arguments after ``bh``."""
    from ..utils import cuda_build

    args = [img.data_ptr(), *(img.shape if shape is None else shape), y0.data_ptr(),
            x0.data_ptr(), len(y0), bh, *extra, out.data_ptr(),
            torch.cuda.current_stream(img.device).cuda_stream]
    with torch.cuda.device(img.device):
        rc = getattr(cuda_build.lib(), entry)(*args)
    cuda_build.check(rc, f"{entry} kernel")


def _device_offsets(y0: np.ndarray, x0: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(y0.astype(np.int32)).to(device),
            torch.from_numpy(x0.astype(np.int32)).to(device))


def window_gather_planes(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """(A, P, bh, 128) windows of a (P, Hp, Wp) plane stack at host offsets
    ``y0``/``x0`` (A,), one window across all planes per reflection."""
    if img.device.type == "cpu":
        return window_gather_planes_plain(img, y0, x0, bh=bh)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    y0, x0 = _check(img, y0, x0, bh, planes=True)
    out = torch.empty((len(y0), img.shape[0], bh, LANES), dtype=img.dtype, device=img.device)
    _launch("ffs_window_gather_planes", img.contiguous(), *_device_offsets(y0, x0, img.device),
            bh, out)
    window_gather_planes.launches += 1
    return out


def window_gather(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """(A, bh, 128) windows of one (Hp, Wp) plane at host offsets
    ``y0``/``x0`` (A,)."""
    if img.device.type == "cpu":
        return window_gather_plain(img, y0, x0, bh=bh)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    y0, x0 = _check(img, y0, x0, bh, planes=False)
    out = torch.empty((len(y0), bh, LANES), dtype=img.dtype, device=img.device)
    _launch("ffs_window_gather", img.contiguous(), *_device_offsets(y0, x0, img.device), bh,
            out)
    window_gather.launches += 1
    return out




def pack_windows(windows: torch.Tensor) -> torch.Tensor:
    """(A, P, bh, >=32) windows -> (A/4, P, bh, 128): lanes 32g..32g+31 of
    row i hold columns 0..31 of window 4i+g."""
    a, p, bh = windows.shape[:3]
    return (windows[..., :32].reshape(a // 4, 4, p, bh, 32).permute(0, 2, 3, 1, 4)
            .reshape(a // 4, p, bh, LANES).contiguous())


def _check_packed(img, y0, x0, bh):
    y0, x0 = _check(img, y0, x0, bh, planes=True)
    if len(y0) % 4:
        raise ValueError(f"the packed gather needs a multiple of 4 windows, got {len(y0)}")
    return y0, x0


def window_gather_planes_packed_plain(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`window_gather_planes_packed`."""
    _check_packed(img, y0, x0, bh)
    return pack_windows(window_gather_planes_plain(img, y0, x0, bh=bh))


def window_gather_planes_packed(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """(A/4, P, bh, 128) lane-packed windows of a (P, Hp, Wp) plane stack:
    columns 0..31 of four windows a row, A a multiple of 4."""
    if img.device.type == "cpu":
        return window_gather_planes_packed_plain(img, y0, x0, bh=bh)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    y0, x0 = _check_packed(img, y0, x0, bh)
    out = torch.empty((len(y0) // 4, img.shape[0], bh, LANES), dtype=img.dtype,
                      device=img.device)
    _launch("ffs_window_gather_planes_packed", img.contiguous(),
            *_device_offsets(y0, x0, img.device), bh, out)
    window_gather_planes_packed.launches += 1
    return out


def _check_pl(img, y0, x0, bh):
    if img.dim() != 4 or img.shape[-1] != LANES:
        raise ValueError(f"plane-last image must be (Hp, Wp/128, P, 128), got {tuple(img.shape)}")
    hp, wb = img.shape[:2]
    return _check_windows(img.dtype, hp, wb * LANES, y0, x0, bh)


def window_gather_planes_pl_plain(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`window_gather_planes_pl`."""
    y0, x0 = _check_pl(img, y0, x0, bh)
    rows, cols = window_index(y0, x0, bh, img.device)
    # advanced indices split by a slice: the plane axis comes last
    return img[rows, cols // LANES, :, cols % LANES].permute(0, 3, 1, 2).contiguous()


def window_gather_planes_pl(img: torch.Tensor, y0, x0, *, bh: int) -> torch.Tensor:
    """(A, P, bh, 128) windows, equal to :func:`window_gather_planes`'s,
    from a plane-last (Hp, Wp/128, P, 128) source, e.g.
    ``frames.reshape(P, Hp, Wp // 128, 128).permute(1, 2, 0, 3)``."""
    if img.device.type == "cpu":
        return window_gather_planes_pl_plain(img, y0, x0, bh=bh)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    y0, x0 = _check_pl(img, y0, x0, bh)
    out = torch.empty((len(y0), img.shape[2], bh, LANES), dtype=img.dtype, device=img.device)
    _launch("ffs_window_gather_planes_pl", img.contiguous(),
            *_device_offsets(y0, x0, img.device), bh, out, shape=img.shape[:3])
    window_gather_planes_pl.launches += 1
    return out


def probe_columns(x0: np.ndarray, wp: int, single_only: bool) -> np.ndarray:
    """(A, 128) source columns of the probe's windows: x0 + c, or for the
    single-block form 128*xblk + (c + shift) % 128."""
    c = np.arange(LANES)
    if not single_only:
        return x0[:, None] + c
    xblk = np.minimum(x0 >> 7, wp // LANES - 2)
    shift = x0 - LANES * xblk
    return LANES * xblk[:, None] + (c + shift[:, None]) % LANES


# The probe's ring (csrc/window_gather.cu): four consumer warps and one
# producer warp a block; the shared-memory and thread limits are the H100's.
PROBE_THREADS = 160
PROBE_MAX_BOX = 256  # TMA's largest box dimension
# Words a row of a ring stage: the single form's aligned block; the double
# form's 16-byte aligned start x0 & ~3 (TMA needs it) and the 131 columns it
# may need from there
PROBE_BOX_WIDTH = {True: LANES, False: LANES + 4}
H100_SMEM_BLOCK_OPTIN = 232_448  # shared memory a block may opt in to (227 KB)
H100_SMEM_SM = 233_472  # shared memory an SM holds (228 KB)
SMEM_RESERVED_BLOCK = 1024  # of it, CUDA's own a resident block
SM_THREADS, SM_BLOCKS = 2048, 32


@dataclasses.dataclass(frozen=True)
class ProbePlan:
    """How the probe's kernel lays out its ring for one (P, bh, slots)."""

    stage_planes: int  # planes a ring stage holds: P (a window) or 1 (a window-plane)
    stage_bytes: int  # one stage, a (132 or 128, bh, stage_planes) TMA box of 4-byte words
    smem_bytes: int  # a block's dynamic shared memory: the stages, their barriers, alignment
    blocks_per_sm: int  # resident blocks an SM that shared memory and threads allow
    # an SM's loads in flight while its blocks write a stage out:
    # blocks_per_sm x min(slots - 1, a block's r x P / stage_planes stages) x stage_bytes
    bytes_in_flight: int


def probe_smem_bytes(slots: int, stage_planes: int, bh: int, single_only: bool = False) -> int:
    """A block's dynamic shared memory: ``slots`` stages with a full and an
    empty 8-byte mbarrier each, and 128 bytes to align the first stage."""
    return slots * (stage_planes * bh * PROBE_BOX_WIDTH[bool(single_only)] * 4 + 16) + 128


def probe_plan(planes: int, bh: int, r: int, slots: int, smem_limit: int = H100_SMEM_BLOCK_OPTIN,
               *, single_only: bool = False) -> ProbePlan:
    """The probe's ring for ``planes`` planes of ``bh``-row windows, ``r``
    windows a block and ``slots`` stages, in ``smem_limit`` bytes of shared
    memory a block.  A stage holds a whole window (P planes) or one
    window-plane, whichever of the two that fits keeps more bytes in flight
    an SM (the whole window on a tie: fewer loads and barrier trips); a
    block's ring holds no more loads than its ``r`` windows make.
    Raises ValueError where even ``slots`` window-plane stages do not fit
    (``slots`` is never clamped), and for a box TMA cannot load (bh or P
    over 256).  At the gather tool's bh = 24, P = 4 (double form): a
    window-plane is 12,672 B and a window 50,688 B; slots = 2 and 4 keep
    the same bytes in flight either way and take window stages, slots = 8
    and 16 fit only window-plane stages.  At the integrator's bh = 32 and
    slots = 2, window-plane stages keep six blocks an SM (101 KB in flight)
    where window stages keep one (66 KB).  At r = 1 and slots = 4 a block
    has one window: window-plane stages keep four blocks an SM with three
    loads ahead each, where a window stage would keep one load."""
    if r < 1 or slots < 2:
        raise ValueError(f"r={r} must be >= 1 and slots={slots} >= 2")
    if bh > PROBE_MAX_BOX or planes > PROBE_MAX_BOX:
        raise ValueError(f"bh={bh} and P={planes} must be <= {PROBE_MAX_BOX}, "
                         "the largest dimension of a TMA box")
    best = None
    for stage_planes in dict.fromkeys((planes, 1)):
        smem = probe_smem_bytes(slots, stage_planes, bh, single_only)
        if smem > smem_limit:
            continue
        stage = stage_planes * bh * PROBE_BOX_WIDTH[bool(single_only)] * 4
        blocks = min(H100_SMEM_SM // (smem + SMEM_RESERVED_BLOCK), SM_THREADS // PROBE_THREADS,
                     SM_BLOCKS)
        ahead = min(slots - 1, r * planes // stage_planes)
        plan = ProbePlan(stage_planes, stage, smem, blocks, blocks * ahead * stage)
        if best is None or plan.bytes_in_flight > best.bytes_in_flight:
            best = plan
    if best is None:
        raise ValueError(f"slots={slots} window-plane stages of bh={bh} rows need {smem} B of "
                         f"shared memory a block, over the {smem_limit} B limit; "
                         "lower slots or bh")
    return best


def probe_extra(single_only: bool, r: int, slots: int, plan: ProbePlan) -> tuple[int, ...]:
    """The probe entry's int arguments after ``bh``."""
    return int(single_only), int(r), int(slots), plan.stage_planes, plan.smem_bytes


def _check_probe(img, y0, x0, bh, single_only, r, slots, smem_limit=H100_SMEM_BLOCK_OPTIN):
    """The gather contract, the ring's plan and a 16-byte aligned base (the
    tensor map's); returns the host offsets and the plan."""
    y0, x0 = _check(img, y0, x0, bh, planes=True)
    plan = probe_plan(img.shape[0], bh, r, slots, smem_limit, single_only=single_only)
    if img.is_contiguous() and img.data_ptr() % 16:
        raise ValueError(f"the probe's image must start 16-byte aligned (a TMA tensor map's "
                         f"base), got data_ptr() % 16 = {img.data_ptr() % 16}")
    return y0, x0, plan


def window_gather_probe_plain(img: torch.Tensor, y0, x0, *, bh: int, single_only: bool = False,
                              r: int = 8, slots: int = 2) -> torch.Tensor:
    """The plain PyTorch version of :func:`window_gather_probe`, under the
    same checks; ``r`` and ``slots`` change nothing in the result."""
    y0, x0, _ = _check_probe(img, y0, x0, bh, single_only, r, slots)
    rows, _ = window_index(y0, x0, bh, img.device)
    cols = torch.as_tensor(probe_columns(x0, img.shape[-1], single_only), device=img.device)
    return img[:, rows, cols[:, None, :]].permute(1, 0, 2, 3).contiguous()


def window_gather_probe(img: torch.Tensor, y0, x0, *, bh: int, single_only: bool = False,
                        r: int = 8, slots: int = 2) -> torch.Tensor:
    """The measurement probe's (A, P, bh, 128) windows of a (P, Hp, Wp)
    stack.  ``r`` is the windows each CUDA block serves.  ``slots`` is the
    depth of the block's ring of shared-memory stages, which TMA loads fill
    while the block writes out an earlier one: up to ``slots - 1`` loads
    in flight a block, each a whole window or one window-plane as
    :func:`probe_plan` decides, so it changes the bytes in flight and
    never the result.  A plan that does not fit the card's shared memory,
    a box over 256 rows or planes, or an image not 16-byte aligned raises
    ValueError before anything runs."""
    if img.device.type == "cpu":
        return window_gather_probe_plain(img, y0, x0, bh=bh, single_only=single_only, r=r,
                                         slots=slots)
    if img.device.type != "cuda":
        raise ValueError(f"no kernel for device {img.device}")
    src = img.contiguous()
    limit = torch.cuda.get_device_properties(src.device).shared_memory_per_block_optin
    y0, x0, plan = _check_probe(src, y0, x0, bh, single_only, r, slots, limit)
    out = torch.empty((len(y0), src.shape[0], bh, LANES), dtype=src.dtype, device=src.device)
    _launch("ffs_window_gather_probe", src, *_device_offsets(y0, x0, src.device), bh, out,
            extra=probe_extra(single_only, r, slots, plan))
    window_gather_probe.launches += 1
    return out


window_gather_planes.launches = 0
window_gather.launches = 0
window_gather_planes_packed.launches = 0
window_gather_planes_pl.launches = 0
window_gather_probe.launches = 0
