"""The port's side of tests/test_torch_parallel.py and its GPU twin.

Rank functions for ``ffs_tpu_torch.parallel.launch.run_ranks`` live here, in
a module that imports neither JAX nor ``ffs_tpu``: the spawned ranks block
both before they import it.  :func:`inputs` makes every host array of the
cases from numpy seeds; the test hands the same arrays to ``ffs_tpu``.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ffs_tpu_torch.parallel import dryrun
from ffs_tpu_torch.parallel import mesh as pm

TRUSTED = 65535.0
KF = 2048  # slots a frame (DP, rotation)
SP_K, SP_SPOTS = 1024, 512  # slots a row shard, table rows (SP)
KABSCH_SHORT = 29  # reflections of the short Kabsch chunk (max_active 32)


def _kabsch_geometry():
    from ffs_tpu_torch.models.geometry import Goniometer, MonochromaticBeam, Scan, simple_panel

    a, f, h, w = 32, 2, 160, 256
    return dict(
        panel=simple_panel(150.0, (w / 2, h / 2), (0.075, 0.075), (w, h)),
        beam=MonochromaticBeam(wavelength=0.976), gonio=Goniometer(),
        scan=Scan(image_range=(1, 10), oscillation=(0.0, 0.1)), shape=(a, f, h, w),
    )


def inputs(world: int) -> dict:
    """Every host array of the cases at ``world`` ranks (the JAX tests'
    sizes: 64 x 256 frames, 128 x 192 SP frames, 16 rows a shard for the
    extended SP, a 32-reflection Kabsch chunk over two 160 x 256 frames)."""
    from ffs_tpu_torch.io import compression

    rng = np.random.default_rng(20261017 + world)
    h, w = 64, 256
    mask = np.ones((h, w), np.uint8)
    mask[:, 150:153] = 0  # a module gap
    frames = rng.poisson(3.0, size=(8, h, w)).astype(np.uint16)
    frames[:, 30:33, 100:103] = 900
    for i in range(8):  # a few more spots, at other places in every frame
        y, x = 8 + 6 * i, 20 + 25 * i
        frames[i, y : y + 3, x : x + 4] += rng.poisson(300, size=(3, 4)).astype(np.uint16)
    frames[:, mask == 0] = 0
    planes = np.stack([
        compression.bshuf_lz4_planes(compression.bshuf_lz4_compress(f, 2), h * w, 2)[0]
        for f in frames
    ])

    halo = rng.poisson(4.0, size=(128, 192)).astype(np.uint16)
    halo[60:68, 90:94] = 700  # across the boundary of rows 63/64

    # spots across every shard boundary at 2 and 4 ranks (rows 32, 64, 96),
    # a tall one across three shards at 4
    sp = rng.poisson(4.0, size=(128, 192)).astype(np.uint16)
    sp[29:35, 30:34] = 700
    sp[60:68, 90:94] = 900
    sp[94:99, 150:153] = 650
    sp[20:70, 10:12] = 800
    he = 16 * world
    ext = rng.poisson(4.0, size=(he, 192)).astype(np.uint16)
    for b in range(1, world):  # every boundary of the 16-row shards
        ext[16 * b - 3 : 16 * b + 4, 20 + 40 * b : 25 + 40 * b] = 900
    ext[2:9, 150:154] = 700

    rot = rng.poisson(3.0, size=(2 * world, h, w)).astype(np.uint16)
    rot[1, 40:43, 200:203] = 700  # across the rank-0/1 frame pair (2 frames a rank)
    rot[2, 41:44, 200:203] = 700
    rot[3, 42:44, 201:203] = 700

    geo = _kabsch_geometry()
    a, f, ih, iw = geo["shape"]
    x = rng.uniform(20, iw - 20, a)
    y = rng.uniform(20, ih - 20, a)
    kphi = np.deg2rad(rng.uniform(0, 0.2, a))
    kimage = rng.poisson(4.0, size=(f, ih, iw)).astype(np.uint16)
    kimage[:, 80:83, 120:123] = 600
    kmask = np.ones((ih, iw), np.uint8)
    kmask[70:74, :] = 0  # a module gap through some shoeboxes
    return dict(frames=frames, mask=mask, planes=planes, halo=halo, sp=sp, ext=ext, rot=rot,
                kx=x, ky=y, kphi=kphi, kimage=kimage, kmask=kmask)


def kabsch_setup(integrator_cls, inp: dict, **device):
    """(integrator, cs_e1, cs_e2, zeta) of the Kabsch case, for either
    package's ``KabschIntegrator`` (with ``device=`` for the port's), its
    detector mask set."""
    geo = _kabsch_geometry()
    a, f, ih, iw = geo["shape"]
    panel, beam, gonio = geo["panel"], geo["beam"], geo["gonio"]
    x, y = inp["kx"], inp["ky"]
    lab = panel.get_lab_coord(*panel.px_to_mm(x, y))
    s1 = lab / np.linalg.norm(lab, axis=1, keepdims=True) / beam.wavelength
    bboxes = np.stack(
        [np.clip(x - 5, 0, iw - 1), np.clip(x + 5, 0, iw - 1),
         np.clip(y - 5, 0, ih - 1), np.clip(y + 5, 0, ih - 1), np.zeros(a), np.full(a, f)],
        axis=1,
    ).astype(np.int64)
    integ = integrator_cls(
        panel=panel, beam=beam, gonio=gonio, scan=geo["scan"], s1=s1, phi=inp["kphi"],
        bboxes=bboxes, delta_b=np.deg2rad(0.3), delta_m=np.deg2rad(1.0), max_active=a, **device,
    )
    integ.set_mask(inp["kmask"])
    cs_e1 = np.cross(s1, np.asarray(beam.s0))
    cs_e1 /= np.linalg.norm(cs_e1, axis=1, keepdims=True)
    cs_e2 = np.cross(s1, cs_e1)
    cs_e2 /= np.linalg.norm(cs_e2, axis=1, keepdims=True)
    zeta = cs_e1 @ (gonio.rotation_axis / np.linalg.norm(gonio.rotation_axis))
    return integ, cs_e1, cs_e2, zeta


def kabsch_block_args(f: int):
    """(phi_lows, d_osc, z_values, frame_ok) of the Kabsch case's block."""
    return (np.deg2rad(np.arange(f) * 0.1), float(np.deg2rad(0.1)),
            np.arange(f, dtype=np.float64), np.ones(f, dtype=bool))


def _raised(fn) -> tuple[str, str] | None:
    """(exception type, message) of ``fn()``, or None if it returned."""
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


def _guards(mesh, inp: dict) -> dict:
    """Every guard of the mesh functions, run on this rank; a shape guard
    raises before any collective, a capacity check after one, so every
    rank records the same raise and none is left waiting."""
    n = mesh.size
    img = inp["halo"]
    ones = np.ones_like(img, dtype=np.uint8)
    odd = np.ones((2 * n + 1, 8, 8), np.uint16)
    return {
        "counts_batch": _raised(lambda: pm.sharded_spotfind_counts(mesh, odd, ones[:8, :8], TRUSTED)),
        "packed_batch": _raised(lambda: pm.sharded_packed_pipeline(mesh, odd, ones[:8, :8], TRUSTED)),
        "planes_batch": _raised(lambda: pm.sharded_packed_pipeline_planes(
            mesh, inp["planes"][: 2 * n - 1], inp["frames"].shape[1:], np.uint16, inp["mask"],
            TRUSTED)),
        "rotation_batch": _raised(lambda: pm.sharded_rotation_compact(
            mesh, odd, ones[:8, :8], TRUSTED)),
        "halo_rows": _raised(lambda: pm.halo_sharded_dispersion(
            mesh, img[: 8 * n + 1], ones[: 8 * n + 1], TRUSTED)),
        "halo_short": _raised(lambda: pm.halo_sharded_dispersion(
            mesh, img[: 2 * n], ones[: 2 * n], TRUSTED)),
        "sp_rows": _raised(lambda: pm.sharded_packed_sp_pipeline(
            mesh, img[: 8 * n + 1], ones[: 8 * n + 1], TRUSTED)),
        "sp_extended_halo": _raised(lambda: pm.sharded_packed_sp_pipeline(
            mesh, img[: 8 * n], ones[: 8 * n], TRUSTED, extended=True)),
        "kabsch_chunk": _raised(lambda: pm.sharded_kabsch_block_step(
            mesh, None, None, {"x0": np.zeros(2 * n + 1)}, None, 0.0, None, None)),
        "kabsch_setup_chunk": _raised(lambda: pm.sharded_chunk_setup(
            mesh, SimpleNamespace(max_active=2 * n + 1), np.arange(n), None, None, None)),
        "kabsch_setup_overflow": _raised(lambda: pm.sharded_chunk_setup(
            mesh, SimpleNamespace(max_active=2 * n), np.arange(2 * n + 1), None, None, None)),
        "packed_overflow": _raised(lambda: pm.sharded_packed_pipeline(
            mesh, inp["frames"], inp["mask"], TRUSTED, max_pixels_per_frame=4)),
        "sp_spot_overflow": _raised(lambda: pm.sharded_packed_sp_pipeline(
            mesh, inp["sp"], np.ones_like(inp["sp"], dtype=np.uint8), TRUSTED,
            max_pixels_per_chip=SP_K, max_spots=2)),
        "sp_pixel_overflow": _raised(lambda: pm.sharded_packed_sp_pipeline(
            mesh, inp["sp"], np.ones_like(inp["sp"], dtype=np.uint8), TRUSTED,
            max_pixels_per_chip=8)),
        "rotation_overflow": _raised(lambda: pm.sharded_rotation_compact(
            mesh, inp["rot"], inp["mask"], TRUSTED, max_pixels_per_frame=4)),
    }


def _halo_fills(mesh) -> dict:
    """The halo exchange of a (4, 3) int32 block holding rank*100 + index,
    with the default zero fill and a BIG fill."""
    from ffs_tpu_torch.ops.connected_components import BIG

    x = (torch.arange(12, dtype=torch.int32, device=mesh.device).reshape(4, 3)
         + 100 * mesh.rank)
    return {"zero": pm._halo_exchange(x, 2, mesh), "big": pm._halo_exchange(x, 1, mesh, BIG),
            "u16": pm._halo_exchange(x.to(torch.int16).view(torch.uint16), 2, mesh)}


def kernel_wrappers() -> list:
    """The wrappers of the kernels the mesh functions run (rows 1-5)."""
    from ffs_tpu_torch.ops import bitshuffle_device as bd
    from ffs_tpu_torch.ops import dispersion_extended_packed as dxp
    from ffs_tpu_torch.ops import dispersion_packed as dp
    from ffs_tpu_torch.ops import window_gather as wg

    return [dp.dispersion_packed_raw, dxp.dispersion_extended_packed_raw,
            wg.window_gather_planes, wg.window_gather, bd.frames_from_planes]


def rank_cases(world: int, backend: str = "gloo") -> dict:
    """Every mesh function on the seeded inputs at ``world`` ranks, the
    guards, the halo fills and the dry run; the results as this rank sees
    them (tensors come back on the CPU)."""
    from ffs_tpu_torch.integration.kabsch import KabschIntegrator

    mesh = pm.make_mesh(world, backend=backend)
    inp = inputs(world)
    for fn in kernel_wrappers():
        fn.launches = 0
    out = {"rank": mesh.rank, "device": str(mesh.device)}
    out["counts"] = pm.sharded_spotfind_counts(mesh, inp["frames"], inp["mask"], TRUSTED)
    out["halo"] = pm.halo_sharded_dispersion(
        mesh, inp["halo"], np.ones_like(inp["halo"], dtype=np.uint8), TRUSTED)
    out["shard"] = pm.shard_frames(mesh, inp["frames"])
    kw = dict(max_pixels_per_frame=KF, max_spots_per_chip=KF)
    out["packed"] = pm.sharded_packed_pipeline(mesh, inp["frames"], inp["mask"], TRUSTED, **kw)
    out["planes"] = pm.sharded_packed_pipeline_planes(
        mesh, inp["planes"], inp["frames"].shape[1:], np.uint16, inp["mask"], TRUSTED, **kw)
    for key, extended in (("sp", False), ("ext", True)):
        frame = inp[key]
        out[key] = pm.sharded_packed_sp_pipeline(
            mesh, frame, np.ones_like(frame, dtype=np.uint8), TRUSTED,
            max_pixels_per_chip=SP_K, max_spots=SP_SPOTS, extended=extended)
        out[key + "_rounds"] = pm.sharded_packed_sp_pipeline.merge_rounds
    # ADVICE.md:3: a 10-row extended halo (3 + erosion's 2 + 5) would do;
    # the port keeps the JAX package's 11, and this holds the claim
    saved = pm.KERNEL_RADIUS_EXTENDED
    pm.KERNEL_RADIUS_EXTENDED = saved - 1
    try:
        out["ext_halo10"] = pm.sharded_packed_sp_pipeline(
            mesh, inp["ext"], np.ones_like(inp["ext"], dtype=np.uint8), TRUSTED,
            max_pixels_per_chip=SP_K, max_spots=SP_SPOTS, extended=True)
    finally:
        pm.KERNEL_RADIUS_EXTENDED = saved
    out["rotation"] = pm.sharded_rotation_compact(
        mesh, inp["rot"], inp["mask"], TRUSTED, max_pixels_per_frame=KF)

    integ, cs_e1, cs_e2, zeta = kabsch_setup(KabschIntegrator, inp, device=mesh.device)
    dev = integ._chunk_setup(np.arange(len(inp["kx"])), cs_e1, cs_e2, zeta)
    frames = integ.pad_frames(torch.from_numpy(inp["kimage"]).to(mesh.device))
    out["kabsch"] = pm.sharded_kabsch_block_step(
        mesh, integ, frames, dev, *kabsch_block_args(len(inp["kimage"])))
    # each rank sets up its own rows: the whole chunk, and one short of
    # KABSCH_SHORT reflections (the last rank's rows partly padding)
    for key, a in (("kabsch_local", len(inp["kx"])), ("kabsch_local_short", KABSCH_SHORT)):
        local = pm.sharded_chunk_setup(mesh, integ, np.arange(a), cs_e1, cs_e2, zeta)
        out[key] = pm.sharded_kabsch_block_step(
            mesh, integ, frames, local, *kabsch_block_args(len(inp["kimage"])), local=True)

    out["guards"] = _guards(mesh, inp)
    out["fills"] = _halo_fills(mesh)
    out["dryrun"] = dryrun.dryrun(mesh)
    out["launches"] = {fn.__name__: fn.launches for fn in kernel_wrappers()}
    return out


def lone_failure(how: str) -> None:
    """Rank 1 fails (raises, or its process dies) while rank 0 waits in a
    collective it will never complete."""
    import os

    mesh = pm.make_mesh()
    if mesh.rank == 1:
        if how == "raise":
            raise ValueError("rank 1 fails alone")
        os._exit(3)
    pm.all_reduce(torch.ones((), dtype=torch.int64), mesh)
