"""Multi-device dry run: every sharded function once, held to its
single-device result.

Counterpart of ``__graft_entry__.dryrun_multichip``: the same sections,
sizes, seeds and assertions, each rank a process of a ``--world``-rank
group (:func:`ffs_tpu_torch.parallel.launch.run_ranks`)::

    FFS_TORCH_DEVICE=cpu python -m ffs_tpu_torch.parallel.dryrun --world 4   # gloo
    python -m ffs_tpu_torch.parallel.dryrun --world 4                        # NCCL, 4 cards
    python -m ffs_tpu_torch.parallel.dryrun --world 2 --backend gloo         # ranks share cards

Sections: DP counts over a frame batch; the halo-sharded threshold of one
frame; DP of the packed pipeline from frames and from bitshuffle planes;
SP of the packed pipeline, plain and extended (deep halo), with spots
across shard boundaries; DP of a rotation collection through the host 3D
merge, with a spot across the rank boundary; the reflection-parallel
Kabsch block step.  Prints a summary per rank and exits non-zero on any
mismatch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from . import mesh as pm
from .launch import run_ranks


def _check(ok, what: str) -> None:
    """The dry run's assertion (kept under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def _table_equal(got, want) -> int:
    """Spot count of two replicated tables after asserting every column of
    their valid rows equal."""
    ns = int(want.n_spots)
    _check(int(got.n_spots) == ns > 0, f"spot count {int(got.n_spots)} != {ns}")
    for field in want._fields:
        if field != "n_spots":
            a, b = getattr(got, field)[:ns], getattr(want, field)[:ns]
            _check(torch.equal(a, b), f"table column {field} diverged")
    return ns


def single_table(frame, mask, k, max_spots, extended, device):
    """The single-device packed path of one frame: threshold kernel,
    compaction into ``k`` slots, CC and the float32 spot table of
    ``max_spots`` rows; returns (pixels, table).  The reference of the SP
    pipeline here and in ``chip_smoke.py``."""
    from ..ops import connected_components as cc
    from ..ops.compact import compact_from_pcw
    from ..ops.dispersion_extended_packed import dispersion_extended_packed_raw
    from ..ops.dispersion_packed import dispersion_packed_raw

    img = torch.from_numpy(frame).to(device)
    raw = dispersion_extended_packed_raw if extended else dispersion_packed_raw
    pcw = raw(img, torch.from_numpy(mask).to(device), 65535.0)
    px, nbu, nbd = compact_from_pcw(img, pcw, max_pixels=k, with_neighbors=True)
    root = cc.label_compact_pixels(px, width=frame.shape[1], neighbors=(nbu, nbd))
    return px, cc.spot_table_from_pixels(px, root, width=frame.shape[1], max_spots=max_spots,
                                         dtype=torch.float32)


def single_rotation(rot, mask, kf, device):
    """The one-device packed path of a rotation chunk (B, H, W): threshold
    kernel, segmented compaction into ``kf`` slots a frame, 2D CC and the
    host 3D merge; returns (per-frame counts, frame-local ``FramePixels``,
    ``Spots3D``).  The reference of ``sharded_rotation_compact`` here and
    in ``chip_smoke.py``."""
    from ..ops import cc3d
    from ..ops import connected_components as cc
    from ..ops.compact import compact_from_pcw_segmented
    from ..ops.dispersion_packed import dispersion_packed_raw

    b, _, w = rot.shape
    imgs = torch.from_numpy(rot).to(device)
    pcw = dispersion_packed_raw(imgs, torch.from_numpy(mask).to(device), 65535.0)
    p, nbu, nbd, pf = compact_from_pcw_segmented(imgs, pcw, max_pixels_per_frame=kf,
                                                 with_neighbors=True)
    root = cc.label_compact_pixels(p, width=w, neighbors=(nbu, nbd)).to(torch.int64)
    lin, pf = p.linear_index.cpu().numpy(), pf.cpu().numpy()
    frames = pm.rotation_frame_pixels(lin, p.intensity.cpu().numpy(), lin[root.cpu().numpy()],
                                      pf, (pcw.shape[1] + 1) * w, kf, b)
    return pf, frames, cc3d.merge_frames(frames, width=w)


def dryrun(mesh: pm.Mesh) -> dict:
    """Every section on this rank's mesh; returns a summary of counts."""
    from ..io import compression
    from ..ops import cc3d
    from ..ops import dispersion as dops

    n, dev = mesh.size, mesh.device
    H, W = 64, 256
    rng = np.random.default_rng(1)
    mask = np.ones((H, W), dtype=np.uint8)
    summary = {}

    # --- DP over a frame batch ---------------------------------------------------
    batch = rng.poisson(3.0, size=(2 * n, H, W)).astype(np.uint16)
    batch[:, 30:33, 100:103] = 800
    per_frame, total = pm.sharded_spotfind_counts(mesh, batch, mask, 65535.0)
    _check(per_frame.shape == (2 * n,), "DP counts: wrong shape")
    _check(int(total) == int(per_frame.sum()) > 0, "DP total is not the sum of the counts, or zero")
    summary["dp_per_frame"] = per_frame.tolist()

    # --- SP over one frame's rows with halo exchange -------------------------------
    frame = batch[0]
    strong_sp = pm.halo_sharded_dispersion(mesh, frame, mask, 65535.0)
    strong_1 = dops.dispersion(torch.from_numpy(frame).to(dev), torch.from_numpy(mask).to(dev),
                               65535.0, dtype=torch.float32)
    _check(torch.equal(strong_sp, strong_1), "halo-sharded dispersion diverged")
    _check(int(per_frame[0]) == int(strong_1.sum()), "halo threshold of frame 0 differs from its DP count")

    # --- DP of the packed pipeline ---------------------------------------------------
    pf2, spots_per_rank, total2 = pm.sharded_packed_pipeline(
        mesh, batch, mask, 65535.0, max_pixels_per_frame=2048, max_spots_per_chip=2048
    )
    _check(torch.equal(pf2, per_frame), "packed DP counts diverged")
    _check(int(total2) == int(total), "packed DP total diverged")
    _check(int(spots_per_rank.sum()) > 0, "packed DP found no spot")
    summary["dp_spots_per_rank"] = spots_per_rank.tolist()

    # --- DP of the device-decode ingestion (bitshuffle planes per rank) --------------
    planes = np.stack([
        compression.bshuf_lz4_planes(compression.bshuf_lz4_compress(f, 2), H * W, 2)[0]
        for f in batch
    ])
    pf3, spots3, total3 = pm.sharded_packed_pipeline_planes(
        mesh, planes, (H, W), np.uint16, mask, 65535.0,
        max_pixels_per_frame=2048, max_spots_per_chip=2048,
    )
    _check(torch.equal(pf3, per_frame), "planes DP counts diverged")
    _check(int(total3) == int(total), "planes DP total diverged")
    _check(torch.equal(spots3, spots_per_rank), "planes DP spots per rank diverged")

    # --- SP of the packed path with the cross-shard label merge ---------------------
    sp_frame = batch[0].copy()
    hs = H // n
    sp_frame[hs - 2 : hs + 2, 60:64] = 900  # a spot across the 0/1 boundary
    table_sp, total_sp = pm.sharded_packed_sp_pipeline(
        mesh, sp_frame, mask, 65535.0, max_pixels_per_chip=1024, max_spots=512
    )
    px1, want_sp = single_table(sp_frame, mask, n * 1024, 512, False, dev)
    summary["sp_spots"] = _table_equal(table_sp, want_sp)
    _check(int(total_sp) == int(px1.count), "SP total diverged")

    # --- SP of the extended algorithm (deep 11-row halo) ------------------------------
    He, We = 16 * n, 192  # 16 rows a shard >= the 11-row halo
    ext_frame = rng.poisson(4.0, size=(He, We)).astype(np.uint16)
    hse = He // n
    ext_frame[hse - 3 : hse + 4, 60:65] = 900  # spans the 0/1 boundary
    ext_frame[2 * hse - 2 : 2 * hse + 2, 120:123] = 700
    emask = np.ones((He, We), np.uint8)
    table_ex, total_ex = pm.sharded_packed_sp_pipeline(
        mesh, ext_frame, emask, 65535.0, max_pixels_per_chip=1024, max_spots=512, extended=True
    )
    pxe, want_ex = single_table(ext_frame, emask, n * 1024, 512, True, dev)
    summary["sp_extended_spots"] = _table_equal(table_ex, want_ex)
    _check(int(total_ex) == int(pxe.count) > 0, "extended SP total diverged, or zero")

    # --- DP of a rotation collection: per-rank spotfind -> host 3D merge --------------
    k, kf = 2, 2048  # frames a rank, slots a frame
    rot = rng.poisson(3.0, size=(k * n, H, W)).astype(np.uint16)
    rot[k - 1, 40:43, 200:203] = 700  # a spot across the rank-0/1 frame pair
    rot[k, 41:44, 200:203] = 700
    rot[k + 1, 42:44, 201:203] = 700
    lin_r, int_r, rl_r, pf_r, pitch = pm.sharded_rotation_compact(
        mesh, rot, mask, 65535.0, max_pixels_per_frame=kf
    )
    spots_dp = cc3d.merge_frames(pm.rotation_frame_pixels(lin_r, int_r, rl_r, pf_r, pitch, kf, k),
                                 width=W)
    pf_1, _, spots_1 = single_rotation(rot, mask, kf, dev)
    _check((pf_1 == pf_r).all(), "rotation DP per-frame counts diverged")
    _check(len(spots_dp) == len(spots_1) > 0, "3D spot count diverged, or zero")
    for fld in dataclasses.fields(cc3d.Spots3D):
        a, b = getattr(spots_dp, fld.name), getattr(spots_1, fld.name)
        _check((np.asarray(a) == np.asarray(b)).all(), f"3D spot field {fld.name} diverged")
    spans = (spots_dp.z_min <= k - 1) & (spots_dp.z_max >= k)
    _check(spans.any(), "no 3D spot spans the rank-boundary frame pair")
    _check(int(spots_dp.z_max[spans][0] - spots_dp.z_min[spans][0]) >= 2,
           "the boundary spot does not span three frames")
    summary["rotation_spots"] = len(spots_dp)

    # --- the reflection-parallel integrator block step --------------------------------
    summary["kabsch_fg_pixels"] = _kabsch_section(mesh, rng)
    return summary


def _kabsch_section(mesh: pm.Mesh, rng) -> int:
    from ..integration import kabsch as kb
    from ..models.geometry import Goniometer, MonochromaticBeam, Scan, simple_panel

    A, F, IH, IW = 4 * mesh.size, 2, 96, 256
    panel = simple_panel(150.0, (IW / 2, IH / 2), (0.075, 0.075), (IW, IH))
    beam = MonochromaticBeam(wavelength=0.976)
    gonio = Goniometer()
    scan = Scan(image_range=(1, 10), oscillation=(0.0, 0.1))
    x = rng.uniform(20, IW - 20, A)
    y = rng.uniform(20, IH - 20, A)
    lab = panel.get_lab_coord(*panel.px_to_mm(x, y))
    s1 = lab / np.linalg.norm(lab, axis=1, keepdims=True) / beam.wavelength
    phi = np.deg2rad(rng.uniform(0, 0.2, A))
    bboxes = np.stack(
        [np.clip(x - 5, 0, IW - 1), np.clip(x + 5, 0, IW - 1),
         np.clip(y - 5, 0, IH - 1), np.clip(y + 5, 0, IH - 1),
         np.zeros(A), np.full(A, F)],
        axis=1,
    ).astype(np.int64)
    integ = kb.KabschIntegrator(
        panel=panel, beam=beam, gonio=gonio, scan=scan, s1=s1, phi=phi, bboxes=bboxes,
        delta_b=np.deg2rad(0.3), delta_m=np.deg2rad(1.0), max_active=A, device=mesh.device,
    )
    cs_e1 = np.cross(s1, np.asarray(beam.s0))
    cs_e1 /= np.linalg.norm(cs_e1, axis=1, keepdims=True)
    cs_e2 = np.cross(s1, cs_e1)
    cs_e2 /= np.linalg.norm(cs_e2, axis=1, keepdims=True)
    zeta = cs_e1 @ (gonio.rotation_axis / np.linalg.norm(gonio.rotation_axis))
    dev = integ._chunk_setup(np.arange(A), cs_e1, cs_e2, zeta)
    image = rng.poisson(4.0, size=(F, IH, IW)).astype(np.uint16)
    frames = integ.pad_frames(torch.from_numpy(image).to(mesh.device))
    phi_lows = torch.from_numpy(np.deg2rad(np.arange(F) * 0.1)).to(mesh.device)
    d_osc = float(np.deg2rad(0.1))
    z_values = torch.arange(F, dtype=torch.float64, device=mesh.device)
    frame_ok = torch.ones(F, dtype=torch.bool, device=mesh.device)
    want = integ._block_step_impl(frames, dev, phi_lows, d_osc, z_values, frame_ok,
                                  centre_slices=True)
    got = pm.sharded_kabsch_block_step(mesh, integ, frames, dev, phi_lows, d_osc, z_values,
                                       frame_ok)
    _check(int(want[1].sum()) > 0, "no foreground classified")
    for i, (g, w) in enumerate(zip(got, want)):
        _check(torch.equal(g, w), f"sharded integrator output {i} diverged")
    return int(want[1].sum())


def rank_dryrun(backend: str) -> dict:
    """One rank of the dry run (run_ranks target)."""
    return dryrun(pm.make_mesh(backend=backend))


def main(argv=None) -> int:
    on_cpu = os.environ.get("FFS_TORCH_DEVICE", "").strip().lower() == "cpu"
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: the CUDA device count; 2 on the CPU)")
    ap.add_argument("--backend", choices=pm.BACKENDS, default="gloo" if on_cpu else "nccl")
    args = ap.parse_args(argv)
    world = args.world or (2 if on_cpu else torch.cuda.device_count())
    summaries = run_ranks(rank_dryrun, world, backend=args.backend, args=(args.backend,))
    if any(s != summaries[0] for s in summaries):
        print(f"dryrun: ranks disagree: {summaries}", file=sys.stderr)
        return 1
    print(json.dumps({"world": world, "backend": args.backend, **summaries[0]}))
    print(f"dryrun ok: {world} ranks ({args.backend})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
