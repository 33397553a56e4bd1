"""Multi-device runs of the spotfinding and integration paths over
``torch.distributed``.

Counterpart of :mod:`ffs_tpu.parallel.mesh`.  JAX drives every chip of a
mesh from one controller; here each device is driven by a process of its
own (a *rank*, started by :func:`ffs_tpu_torch.parallel.launch.run_ranks`),
and the mesh is the process group: NCCL with one rank a card, gloo on the
CPU (``FFS_TORCH_DEVICE=cpu``).  The two layouts of the JAX package:

* **Frame data parallelism (DP)**: a batch of frames split over the ranks
  in contiguous, rank-ordered shards; the only collectives are the global
  totals (``psum`` -> ``all_reduce``) and the all-gather of the per-frame
  results.
* **Intra-frame spatial parallelism (SP)**: one frame's rows split over the
  ranks, with a halo exchange of boundary rows between neighbours
  (``ppermute`` -> paired P2P send/recv) so the windowed statistics are
  exact at the shard boundaries, and a cross-shard label merge of the
  connected components.

The contract of every function: each rank passes the mesh and the same full
host arrays (what JAX's single controller holds) and uploads only its own
shard; the return value is what the JAX function returns, with replicated
values identical on every rank and sharded outputs all-gathered in rank
order.  Every raise of the JAX function is kept and every rank decides it
together: the guards on shapes raise before any collective, the capacity
checks after a collective that gives every rank the same maximum, so no
rank is left waiting in a collective that a lone raise skipped.

The collectives on a gloo group stage their tensors through host memory
(gloo has no CUDA send/recv); that is the one-card rehearsal of
``chip_smoke.py``, where several ranks share ``cuda:0``.  Tensors travel as
bytes (gloo's collectives reject 16-bit integers, NCCL unsigned ones); the
reductions run on int32/int64 only.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..constants import KERNEL_RADIUS, KERNEL_RADIUS_EXTENDED
from ..ops import dispersion as dops
from ..utils.torchinit import DEVICE_ENV, select_device

BACKENDS = ("nccl", "gloo")
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a one-axis device mesh: the process group, this
    rank's index and device, and the backend its collectives run on."""

    group: object  # torch.distributed.ProcessGroup
    rank: int
    size: int
    axis: str
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return {self.axis: self.size}


def make_mesh(
    n_devices: int | None = None, axis: str = "data", *, backend: str | None = None
) -> Mesh:
    """The mesh of the calling rank over the initialised default group.

    ``n_devices`` must be the group's size when given.  The device is
    ``select_device(rank)``: ``cuda:rank``, or the CPU under
    ``FFS_TORCH_DEVICE=cpu``.  The backend is NCCL for a CUDA device and
    gloo for the CPU; ``backend="gloo"`` with CUDA devices is taken only
    when the caller names it, and then the ranks share the cards in turn
    (rank r on ``cuda:r % device_count``), the collectives staging their
    tensors through host memory.  The group must have been initialised
    with the same backend (``run_ranks(..., backend=...)``).
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh runs inside a rank: start the ranks with "
            "ffs_tpu_torch.parallel.launch.run_ranks (or init_process_group)"
        )
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices} but the process group has {size} ranks")
    on_cpu = os.environ.get(DEVICE_ENV, "").strip().lower() == "cpu"
    if on_cpu:
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo runs there")
        backend, device = "gloo", torch.device("cpu")
    elif backend == "gloo":
        device = select_device(rank % max(torch.cuda.device_count(), 1))
    else:
        backend, device = "nccl", select_device(rank)
    group_backend = str(dist.get_backend())
    if group_backend != backend:
        raise ValueError(
            f"the process group runs {group_backend}, the mesh needs {backend}; "
            "start the ranks with the mesh's backend"
        )
    return Mesh(dist.group.WORLD, rank, size, axis, device, backend)


def _size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]  # KeyError for another axis, as in JAX


# --- collectives --------------------------------------------------------------


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as a flat uint8 tensor where the backend moves it."""
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    return flat.cpu() if mesh.backend == "gloo" else flat


def _unwire(b: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    return b.to(like.device).view(like.dtype).reshape(shape)


def all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``psum``: the sum over ranks of an int32 or int64 tensor, a new
    tensor on ``t``'s device."""
    if t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"all_reduce takes int32 or int64, got {t.dtype}")
    w = t.clone() if mesh.backend == "nccl" else t.cpu().clone()
    dist.all_reduce(w, group=mesh.group)
    return w.to(t.device)


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tiled ``all_gather``: every rank's ``t`` (same shape on every
    rank) concatenated along dim 0 in rank order; a 0-d ``t`` gives (n,)."""
    t = t.reshape(1) if t.dim() == 0 else t
    w = _wire(mesh, t)
    if mesh.backend == "nccl":
        out = torch.empty(mesh.size * w.numel(), dtype=torch.uint8, device=w.device)
        dist.all_gather_into_tensor(out, w, group=mesh.group)
    else:
        parts = [torch.empty_like(w) for _ in range(mesh.size)]
        dist.all_gather(parts, w, group=mesh.group)
        out = torch.cat(parts)
    return _unwire(out, t, (mesh.size * t.shape[0], *t.shape[1:]))


def _halo_exchange(x: torch.Tensor, n_rows: int, mesh: Mesh, pad_value=0) -> torch.Tensor:
    """``x`` with ``n_rows`` rows of each neighbour's boundary concatenated
    above and below: the ``ppermute`` up and down of the JAX package, as
    paired P2P sends and receives in one batch (no rank order can
    deadlock).

    Edge ranks have no neighbour there: they get ``pad_value`` rows, zeros
    by default, as ``ppermute`` gives for absent sources."""
    rows = x[:n_rows].shape
    top, bottom = _wire(mesh, x[:n_rows]), _wire(mesh, x[x.shape[0] - n_rows :])
    # built signed: PyTorch's uint16/uint32 lack most CUDA ops
    edge = torch.full(rows, pad_value, dtype=_SIGNED.get(x.dtype, x.dtype),
                      device=x.device).view(x.dtype)
    ops, recv = [], {}
    for peer, send in ((mesh.rank - 1, top), (mesh.rank + 1, bottom)):
        if 0 <= peer < mesh.size:
            recv[peer] = torch.empty_like(send)
            ops += [dist.P2POp(dist.isend, send, peer, group=mesh.group),
                    dist.P2POp(dist.irecv, recv[peer], peer, group=mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    from_above = _unwire(recv[mesh.rank - 1], x, rows) if mesh.rank > 0 else edge
    from_below = _unwire(recv[mesh.rank + 1], x, rows) if mesh.rank + 1 < mesh.size else edge
    parts = [p.contiguous().view(torch.uint8) for p in (from_above, x, from_below)]
    return torch.cat(parts).view(x.dtype)


# --- placement ---------------------------------------------------------------


def _upload(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    # a read-only array (a memory map, a broadcast view) is copied: torch needs writable memory
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


def _shard_rows(mesh: Mesh, n: int, axis: str = "data") -> slice:
    k = n // _size(mesh, axis)
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_frames(mesh: Mesh, frames, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous slice of a (B, H, W) host batch, on its
    device (rank r holds frames [r*B/n, (r+1)*B/n))."""
    n = _size(mesh, axis)
    if frames.shape[0] % n:
        raise ValueError(f"batch ({frames.shape[0]}) must divide the mesh axis ({n})")
    return _upload(frames[_shard_rows(mesh, frames.shape[0], axis)], mesh.device)


# --- data parallelism ----------------------------------------------------------


def sharded_spotfind_counts(
    mesh: Mesh, frames, mask, trusted_max: float, *, dtype=torch.float32, axis: str = "data"
):
    """Strong-pixel counts per frame (B,) and the global total, DP over the
    mesh, through the plain threshold ``ops.dispersion`` (float32 by
    default, as the JAX function)."""
    local = shard_frames(mesh, frames, axis)
    strong = dops.dispersion(local, _upload(mask, mesh.device), trusted_max, dtype=dtype)
    per_frame = strong.sum(dim=(-2, -1), dtype=torch.int32)
    total = all_reduce(per_frame.sum(dtype=torch.int32), mesh)
    return all_gather(per_frame, mesh), total


def _check_halo(h: int, n: int, radius: int, what: str) -> int:
    if h % n:
        raise ValueError(f"rows ({h}) must divide the mesh axis ({n})")
    if h // n < radius:
        raise ValueError(what.format(hs=h // n, r=radius))
    return h // n


def halo_sharded_dispersion(
    mesh: Mesh,
    image,
    mask,
    trusted_max: float,
    *,
    radius: int = KERNEL_RADIUS,
    dtype=torch.float32,
    axis: str = "data",
) -> torch.Tensor:
    """The plain dispersion threshold of ONE (H, W) frame with its rows
    sharded over the ranks: each rank exchanges ``radius`` boundary rows
    with its neighbours, thresholds its padded strip and crops it; the
    strips are all-gathered into the (H, W) bool mask, bit-identical to the
    single-device result."""
    n = _size(mesh, axis)
    h = image.shape[0]
    _check_halo(
        h, n, radius,
        "shard height ({hs}) must be >= the kernel radius ({r}); use fewer chips for this image",
    )
    rows = _shard_rows(mesh, h, axis)
    img = _halo_exchange(_upload(image[rows], mesh.device), radius, mesh)
    # halo mask rows outside the detector are zeros -> masked out, as the
    # single-device zero-padded window sums
    msk = _halo_exchange(_upload(mask[rows], mesh.device), radius, mesh)
    strong = dops.dispersion(img, msk, trusted_max, dtype=dtype)
    return all_gather(strong[radius : radius + h // n], mesh)


def _frame_dtype(frame_dtype) -> torch.dtype:
    if isinstance(frame_dtype, torch.dtype):
        return frame_dtype
    return {np.dtype(np.uint16): torch.uint16, np.dtype(np.uint32): torch.uint32}[
        np.dtype(frame_dtype)]


def _check_frames(per_frame, max_pixels_per_frame: int):
    """Fail loudly on per-frame capacity overflow instead of silently
    truncating the spot list (the counts are exact, the segments cap at the
    capacity, and a down neighbour of an overflowing frame may point past
    its segment, so the check comes before labelling).  ``per_frame`` is
    the gathered counts, the same on every rank, so all raise."""
    worst = int(per_frame.max())
    if worst > max_pixels_per_frame:
        raise RuntimeError(
            f"a frame holds {worst} strong pixels, "
            f"exceeding max_pixels_per_frame={max_pixels_per_frame}; raise it"
        )
    return per_frame


def _packed_chip_body(local_frames, mask_rep, trusted_max, w, max_pixels_per_frame,
                      max_spots_per_chip, mesh):
    """One rank's packed hot path on its frames: the threshold kernel, the
    segmented compaction with neighbours, CC and the spot table.  Returns
    the gathered per-frame counts (B,), spots per rank (n,) and the global
    total; raises on every rank when a frame overflows its segment."""
    from ..ops import connected_components as cc
    from ..ops.compact import compact_from_pcw_segmented
    from ..ops.dispersion_packed import dispersion_packed_raw

    pcw = dispersion_packed_raw(local_frames, mask_rep, trusted_max)
    p, nbu, nbd, local_counts = compact_from_pcw_segmented(
        local_frames, pcw, max_pixels_per_frame=max_pixels_per_frame, with_neighbors=True
    )
    per_frame = _check_frames(all_gather(local_counts, mesh), max_pixels_per_frame)
    root = cc.label_compact_pixels(p, width=w, neighbors=(nbu, nbd))
    table = cc.spot_table_from_pixels(
        p, root, width=w, max_spots=max_spots_per_chip, dtype=torch.float32,
        frame_rows=pcw.shape[1],
    )
    total = all_reduce(local_counts.sum(dtype=torch.int32), mesh)
    n_spots = all_gather(table.n_spots, mesh)
    return per_frame, n_spots, total


def sharded_packed_pipeline(
    mesh: Mesh,
    frames,
    mask,
    trusted_max: float,
    *,
    max_pixels_per_frame: int = 4096,
    max_spots_per_chip: int = 4096,
    axis: str = "data",
):
    """The packed pipeline, data-parallel over the mesh: each rank runs the
    threshold kernel, the segmented compaction, CC and the multi-frame spot
    table on its frames; the collectives are the global total and the
    gathered counts.  The JAX function's u16 ``peak_key_slots`` fold is a
    TPU fast path with the same table; the port has none.

    Returns (per_frame_strong (B,), n_spots_per_rank (n,), global_total ()).
    """
    n = _size(mesh, axis)
    b, _, w = frames.shape
    if b % n:
        raise ValueError(f"batch ({b}) must divide the mesh axis ({n})")
    local = shard_frames(mesh, frames, axis)
    return _packed_chip_body(local, _upload(mask, mesh.device), trusted_max, w,
                             max_pixels_per_frame, max_spots_per_chip, mesh)


def sharded_packed_pipeline_planes(
    mesh: Mesh,
    planes,
    frame_shape: tuple,
    frame_dtype,
    mask,
    trusted_max: float,
    *,
    max_pixels_per_frame: int = 4096,
    max_spots_per_chip: int = 4096,
    axis: str = "data",
):
    """DP of the device-decode ingestion: ``planes`` (B, n_blocks,
    block_bytes) uint8 bitshuffle planes (``io.compression.bshuf_lz4_planes``)
    shard over the batch like frames; each rank assembles its frames on its
    device (``ops.bitshuffle_device.frames_from_planes``) and runs the
    packed body.  Outputs equal :func:`sharded_packed_pipeline` of the
    decoded frames."""
    from ..ops.bitshuffle_device import frames_from_planes

    n = _size(mesh, axis)
    b = planes.shape[0]
    h, w = frame_shape
    if b % n:
        raise ValueError(f"batch ({b}) must divide the mesh axis ({n})")
    if (h * w) % 8:
        raise ValueError(f"device decode needs a multiple-of-8 pixel count, got {h * w}")
    local = frames_from_planes(shard_frames(mesh, planes, axis), h, w, _frame_dtype(frame_dtype))
    return _packed_chip_body(local, _upload(mask, mesh.device), trusted_max, w,
                             max_pixels_per_frame, max_spots_per_chip, mesh)


# --- spatial parallelism --------------------------------------------------------


def sharded_packed_sp_pipeline(
    mesh: Mesh,
    frame,
    mask,
    trusted_max: float,
    *,
    max_pixels_per_chip: int = 8192,
    max_spots: int = 4096,
    axis: str = "data",
    extended: bool = False,
):
    """The packed pipeline on ONE frame, rows sharded over the ranks.

    Each rank runs the threshold kernel on its strip after a halo exchange
    of ``r`` rows (3; 11 for ``extended=True``: first pass 3 + erosion 3 +
    second pass 5, as the JAX function keeps), compacts its own rows with
    the vertical neighbours and labels them.  Components that cross a shard
    boundary are merged by min-propagation of global root linear indices
    over the boundary rows: each round exchanges the boundary rows' minima
    with the neighbours (an edge rank sees ``BIG``, not the zeros of the
    frame halo, since 0 is a valid index) and ends with an ``all_reduce``
    of the changed count, read on the host, so every rank runs the same
    rounds.  The spot table is then tabulated on every rank from the
    all-gathered pixels with the single-device code, so it is bit-identical
    to the single-device packed path (lin = y*W + x, z = 0).  The rounds of
    the last call are kept in ``sharded_packed_sp_pipeline.merge_rounds``.

    Returns the replicated ``SpotTable`` and the global strong-pixel count;
    raises on every rank when a strip overflows ``max_pixels_per_chip`` or
    the frame holds more than ``max_spots`` spots.
    """
    from ..ops import connected_components as cc
    from ..ops.compact import compact_from_pcw
    from ..ops.connected_components import BIG, CompactPixels
    from ..ops.dispersion_extended_packed import dispersion_extended_packed_raw
    from ..ops.dispersion_packed import dispersion_packed_raw

    n = _size(mesh, axis)
    h, w = frame.shape
    r = 2 * KERNEL_RADIUS + KERNEL_RADIUS_EXTENDED if extended else KERNEL_RADIUS
    hs = _check_halo(h, n, r, "shard rows ({hs}) must cover the halo ({r})")
    k = max_pixels_per_chip
    dev = mesh.device
    rows = _shard_rows(mesh, h, axis)

    # --- the rank's packed hot path on its haloed strip -----------------------
    img = _upload(frame[rows], dev)
    img_p = _halo_exchange(img, r, mesh)
    mask_p = _halo_exchange(_upload(mask[rows], dev), r, mesh)
    raw = dispersion_extended_packed_raw if extended else dispersion_packed_raw
    pcw_local = raw(img_p, mask_p, trusted_max)[r : r + hs]  # drop the halo rows
    pixels, nbu, nbd = compact_from_pcw(img, pcw_local, max_pixels=k, with_neighbors=True)
    lin = pixels.linear_index
    in_spot = lin < BIG
    lin_g = torch.where(in_spot, lin + mesh.rank * hs * w, BIG).to(torch.int32)
    root_slot = cc.label_compact_pixels(pixels, width=w, neighbors=(nbu, nbd)).to(torch.int64)

    # --- cross-shard label merge ------------------------------------------------
    px = torch.where(in_spot, lin % w, 0).to(torch.int64)
    py = torch.where(in_spot, torch.div(lin, w, rounding_mode="floor"), -1)
    on_top = in_spot & (py == 0)
    on_bot = in_spot & (py == hs - 1)
    big_w = torch.full((w,), BIG, dtype=torch.int32, device=dev)
    big_k = torch.full((k,), BIG, dtype=torch.int32, device=dev)

    def row_min(sel, root_g):
        return big_w.scatter_reduce(0, px, torch.where(sel, root_g, BIG), "amin")

    root_g = torch.where(in_spot, lin_g[root_slot], BIG).to(torch.int32)
    rounds = 0
    while True:
        rounds += 1
        edges = torch.stack([row_min(on_top, root_g), row_min(on_bot, root_g)])
        halo = _halo_exchange(edges, 1, mesh, pad_value=BIG)
        from_above, from_below = halo[0], halo[3]
        cand = torch.where(on_top, torch.minimum(big_k, from_above[px]), big_k)
        cand = torch.where(on_bot, torch.minimum(cand, from_below[px]), cand)
        # the best boundary candidate reaches the whole local component
        comp_cand = big_k.scatter_reduce(0, root_slot, cand, "amin")
        new = torch.minimum(root_g, comp_cand[root_slot])
        changed = all_reduce((new != root_g).sum(dtype=torch.int64), mesh)
        root_g = new
        if int(changed) == 0:
            break
    sharded_packed_sp_pipeline.merge_rounds = rounds

    # --- replicated tabulation from the all-gathered pixels --------------------
    g = all_gather(torch.stack([lin_g, pixels.intensity, root_g], dim=1), mesh)
    sl, order = torch.sort(g[:, 0], stable=True)
    si, sr = g[order, 1], g[order, 2]
    total = all_reduce(pixels.count.to(torch.int32), mesh)
    counts = all_gather(pixels.count.to(torch.int32), mesh)
    # the root pixel's slot in the sorted order; padding (root == BIG)
    # resolves to its own slot so spot ids stay in range
    slots = torch.arange(n * k, device=dev)
    rs = torch.searchsorted(sl, sr, right=False)
    rs = torch.where(sr < BIG, rs.clamp(0, n * k - 1), slots).to(torch.int32)
    table = cc.spot_table_from_pixels(
        CompactPixels(sl, si, total), rs, width=w, max_spots=max_spots, dtype=torch.float32
    )
    # fail loudly on per-rank capacity overflow (a truncated boundary pixel
    # would also break the merge) and on a truncated table; the gathered
    # counts and the table are the same on every rank, so all raise
    worst = int(counts.max())
    if worst > max_pixels_per_chip:
        raise RuntimeError(
            f"a row shard holds {worst} strong pixels, "
            f"exceeding max_pixels_per_chip={max_pixels_per_chip}; raise it"
        )
    if int(table.n_spots) > max_spots:
        raise RuntimeError(
            f"frame produced {int(table.n_spots)} spots, exceeding max_spots={max_spots}; raise it"
        )
    return table, total


sharded_packed_sp_pipeline.merge_rounds = 0


# --- the integrator's block step -------------------------------------------------


def sharded_chunk_setup(mesh: Mesh, integ, chunk, cs_e1, cs_e2, zeta, *, axis: str = "data"):
    """This rank's rows of ``integ._chunk_setup(chunk, cs_e1, cs_e2, zeta)``,
    set up from this rank's slice of ``chunk`` alone, so each rank gathers
    the windows of its own reflections only.  The chunk pads to
    ``integ.max_active`` rows, which must divide the mesh; rank r holds
    rows [r*m, (r+1)*m), m = max_active / n, bit for bit those of the
    whole chunk's dict.  Pass it to :func:`sharded_kabsch_block_step` with
    ``local=True``."""
    n = _size(mesh, axis)
    a = integ.max_active
    if a % n:
        raise ValueError(f"chunk ({a}) must divide the mesh axis ({n})")
    if len(chunk) > a:
        raise ValueError(f"chunk of {len(chunk)} reflections exceeds max_active={a}")
    rows = _shard_rows(mesh, a, axis)
    return integ._chunk_setup(chunk[rows], cs_e1, cs_e2, zeta, width=a // n)


def sharded_kabsch_block_step(
    mesh: Mesh,
    integ,
    frames,
    dev: dict,
    phi_lows,
    d_osc,
    z_values,
    frame_ok,
    *,
    centre_slices: bool = True,
    local: bool = False,
    axis: str = "data",
):
    """The integrator's block step, reflection-parallel: the frame block is
    replicated and the chunk's reflections shard over the ranks; no
    collective but the gather of the outputs.

    ``integ`` is this rank's ``KabschIntegrator`` (on ``mesh.device``);
    ``dev`` its ``_chunk_setup`` dict for the whole chunk (A reflections,
    A divisible by the mesh), as the JAX function takes it: each rank
    takes its rows of every entry, device tensors and host offsets
    (``y0_host``, ``x0_host``) alike, and moves them to its device (a
    chunk dict held on the host uploads only the shard).  With
    ``local=True``, ``dev`` holds this rank's rows only
    (:func:`sharded_chunk_setup`).  ``frames`` (F, Hp, Wp) int32 is the
    padded block (``integ.pad_frames``).  Returns the eight frame-summed
    outputs of ``_block_step_impl``, (A, ...) each, gathered in rank order.
    """
    if local:
        rows = slice(None)
    else:
        n = _size(mesh, axis)
        a = len(dev["x0"])
        if a % n:
            raise ValueError(f"chunk ({a}) must divide the mesh axis ({n})")
        rows = _shard_rows(mesh, a, axis)
    local_dev = {
        key: (None if v is None else v[rows] if isinstance(v, np.ndarray)
              else v[rows].to(mesh.device))
        for key, v in dev.items()
    }
    out = integ._block_step_impl(
        _upload(frames, mesh.device), local_dev, _upload(phi_lows, mesh.device), d_osc,
        _upload(z_values, mesh.device), _upload(frame_ok, mesh.device),
        centre_slices=centre_slices,
    )
    return tuple(all_gather(o, mesh) for o in out)


# --- rotation collections ----------------------------------------------------------


def sharded_rotation_compact(
    mesh: Mesh,
    frames,
    mask,
    trusted_max: float,
    *,
    max_pixels_per_frame: int = 4096,
    axis: str = "data",
):
    """DP ingestion of a rotation collection: compact pixels for the host 3D
    merge.  Frames shard in acquisition order (rank r holds frames
    [r*k, (r+1)*k)); each rank runs the threshold kernel, the segmented
    compaction with neighbours and 2D CC, and the slot arrays are gathered
    to every rank.  The host then merges the per-frame fragments in 3D
    (``ops.cc3d.merge_frames`` over :func:`rotation_frame_pixels`),
    including the frame pair that straddles a rank boundary.

    Returns host arrays, rank-major so frame f = r*k + j occupies slots
    [f*Kf, f*Kf + per_frame[f]): (linear_index (B*Kf,), intensity (B*Kf,),
    root_lin (B*Kf,), per_frame (B,), pitch); linear indices and roots are
    in the rank-local batch space (frame-local = value - j * pitch).  The
    pitch is (H + 1) * W: the JAX function's counts the Pallas strip
    padding of its untrimmed output, (padded rows + 1) * W, so the tall
    values differ between the two packages while the frame-local pixels,
    counts and 3D spots are the same.
    """
    from ..ops import connected_components as cc
    from ..ops.compact import compact_from_pcw_segmented
    from ..ops.dispersion_packed import dispersion_packed_raw

    n = _size(mesh, axis)
    b, _, w = frames.shape
    if b % n:
        raise ValueError(f"collection chunk ({b}) must divide the mesh axis ({n})")
    local = shard_frames(mesh, frames, axis)
    pcw = dispersion_packed_raw(local, _upload(mask, mesh.device), trusted_max)
    p, nbu, nbd, local_counts = compact_from_pcw_segmented(
        local, pcw, max_pixels_per_frame=max_pixels_per_frame, with_neighbors=True
    )
    per_frame = _check_frames(all_gather(local_counts, mesh), max_pixels_per_frame)
    root = cc.label_compact_pixels(p, width=w, neighbors=(nbu, nbd))
    slots = torch.stack([p.linear_index, p.intensity, p.linear_index[root.to(torch.int64)]], dim=1)
    g = all_gather(slots, mesh).cpu().numpy()
    pitch = (pcw.shape[1] + 1) * w
    return g[:, 0].copy(), g[:, 1].copy(), g[:, 2].copy(), per_frame.cpu().numpy(), pitch


def rotation_frame_pixels(lin, inten, root_lin, per_frame, pitch, kf, k):
    """Slice :func:`sharded_rotation_compact`'s slot arrays into per-frame
    ``cc3d.FramePixels`` (acquisition order), shifting rank-local linear
    indices to frame-local (j = frame index within its rank's shard of k
    frames; kf = max_pixels_per_frame)."""
    from ..ops import cc3d

    out = []
    for f in range(len(per_frame)):
        j = f % k
        sl = slice(f * kf, f * kf + int(per_frame[f]))
        out.append(
            cc3d.FramePixels(
                linear_index=lin[sl] - j * pitch,
                intensity=inten[sl],
                root=root_lin[sl] - j * pitch,
            )
        )
    return out
