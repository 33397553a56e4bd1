"""Batched collection and device decode of ffs_tpu_torch against ffs_tpu.

The port's processor (kernel path on the CPU: the kernels' plain PyTorch
versions) against the JAX processor (Pallas packed path in interpret mode)
on the same frames: ``collect_batch`` field by field, the segmented
compaction, and the CLI's ``--batch`` / ``--decode-backend device`` runs
over a NeXus file and a /dev/shm-style directory.  Everything compared is
an integer or a float32 computed the same way, so every comparison is
exact.
"""

import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffs_tpu.ops import compact as jcomp
from ffs_tpu.spotfind import SpotfindConfig as JConfig
from ffs_tpu.spotfind import SpotfindProcessor as JProcessor
from ffs_tpu_torch.io import compression
from ffs_tpu_torch.ops import compact as tcomp
from ffs_tpu_torch.ops import dispersion_packed as tp
from ffs_tpu_torch.spotfind import SpotfindConfig, SpotfindProcessor

from .util import synthetic_rotation_stack, write_nexus

CPU = torch.device("cpu")
COUNT_LINE = re.compile(
    r"^(Thread .*finished image.*|Extracted \d+ spots|Removed \d+ spots.*|"
    r"Calculated \d+ spots|Filtered \d+ spots.*|Found \d+ spots|Estimated sigma.*|"
    r"Successfully wrote.*|Dataset type:.*|Image: .*)$"
)


def _configs(cc_backend, **kw):
    common = dict(precision="f32", cc_backend=cc_backend, max_strong_pixels=4096,
                  max_spots=2048, min_spot_size=1, **kw)
    return (JConfig(use_pallas=True, pallas_interpret=True, **common),
            SpotfindConfig(use_kernel=True, **common))


def _processors(stack, mask, cc_backend, tm=65535.0, **kw):
    h, w = stack.shape[1:]
    jcfg, tcfg = _configs(cc_backend, **kw)
    return (JProcessor(w, h, mask, tm, jcfg),
            SpotfindProcessor(w, h, mask, tm, tcfg, device=CPU))


def _assert_same(got, want):
    """Two FrameResults equal in every field, arrays bit for bit."""
    assert (got.image_number, got.n_strong_pixels, got.n_spots, got.n_spots_prefilter,
            got.n_strong_pixels_filtered) == (
        want.image_number, want.n_strong_pixels, want.n_spots, want.n_spots_prefilter,
        want.n_strong_pixels_filtered)
    for name in ("linear_index", "intensity", "root"):
        a, b = np.asarray(getattr(got.pixels, name)), np.asarray(getattr(want.pixels, name))
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.centers_of_mass.dtype == want.centers_of_mass.dtype
    np.testing.assert_array_equal(got.centers_of_mass, want.centers_of_mass)


def _stack32():
    stack, mask = synthetic_rotation_stack()
    stack32 = stack.astype(np.uint32)
    stack32[2, 50:53, 10:13] = 70000  # beyond u16
    stack32[4, 20, 100] = 0xFFFFFFFF  # saturation sentinel, past trusted_max
    return stack32, mask


@pytest.mark.parametrize("pixels", ["u16", "u32"])
@pytest.mark.parametrize("cc_backend", ["host", "device"])
def test_collect_batch_matches_jax(cc_backend, pixels):
    if pixels == "u16":
        (stack, mask), tm = synthetic_rotation_stack(), 65535.0
    else:
        (stack, mask), tm = _stack32(), float(2**31 - 1)
    jproc, tproc = _processors(stack, mask, cc_backend, tm)
    assert tproc.batch_supported() and jproc.batch_supported()
    nums = list(range(len(stack)))
    want = jproc.collect_batch(nums, jproc.dispatch_batch(stack), images=stack, want_com=True)
    got = tproc.collect_batch(nums, tproc.dispatch_batch(stack), images=stack, want_com=True)
    assert len(got) == len(want) == len(stack)
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert sum(g.n_strong_pixels for g in got) > 0
    assert any(len(g.centers_of_mass) for g in got)
    # and the port's per-frame path gives the same pixels
    for g in got:
        p = tproc.process_frame(g.image_number, stack[g.image_number], want_com=True)
        np.testing.assert_array_equal(g.pixels.linear_index, p.pixels.linear_index)
        np.testing.assert_array_equal(g.pixels.root, p.pixels.root)
        assert (g.n_spots, g.n_spots_prefilter) == (p.n_spots, p.n_spots_prefilter)
    if pixels == "u32":
        assert any((g.pixels.intensity > 65535).any() for g in got)


def test_partial_tail_batch_zero_padding():
    stack, mask = synthetic_rotation_stack()
    jproc, tproc = _processors(stack, mask, "device")
    padded = np.concatenate([stack[:2], np.zeros_like(stack[:2])])
    want = jproc.collect_batch([0, 1], jproc.dispatch_batch(padded), images=stack[:2],
                               want_com=True)
    got = tproc.collect_batch([0, 1], tproc.dispatch_batch(padded), images=stack[:2],
                              want_com=True)
    assert len(got) == 2
    for g, w in zip(got, want):
        _assert_same(g, w)


@pytest.mark.parametrize("cc_backend", ["host", "device"])
def test_overflow_falls_back_per_frame(cc_backend):
    stack, mask = synthetic_rotation_stack()
    jproc, tproc = _processors(stack, mask, cc_backend, batch_max_px_per_frame=16)
    nums = range(len(stack))
    want = jproc.collect_batch(nums, jproc.dispatch_batch(stack), images=stack, want_com=True)
    got = tproc.collect_batch(nums, tproc.dispatch_batch(stack), images=stack, want_com=True)
    assert any(g.n_strong_pixels > 16 for g in got), "the fixture must overflow 16 slots"
    for g, w in zip(got, want):
        _assert_same(g, w)
    with pytest.raises(RuntimeError, match="exceed the batched"):
        tproc.collect_batch(nums, tproc.dispatch_batch(stack))


def test_max_spots_raises():
    stack, mask = synthetic_rotation_stack()
    h, w = stack.shape[1:]
    cfg = SpotfindConfig(precision="f32", use_kernel=True, cc_backend="device", max_spots=2,
                         min_spot_size=1)
    proc = SpotfindProcessor(w, h, mask, 65535.0, cfg, device=CPU)
    with pytest.raises(RuntimeError, match="exceeding max_spots=2"):
        proc.collect_batch(range(len(stack)), proc.dispatch_batch(stack), images=stack)


@pytest.mark.parametrize("cc_backend", ["host", "device"])
def test_dispatch_batch_planes_equals_dispatch_batch(cc_backend):
    for stack, mask, tm, dtype in (
        (*synthetic_rotation_stack(), 65535.0, np.uint16),
        (*_stack32(), float(2**31 - 1), np.uint32),
    ):
        _, tproc = _processors(stack, mask, cc_backend, tm)
        planes = np.stack([
            compression.bshuf_lz4_planes(
                compression.bshuf_lz4_compress(f, f.dtype.itemsize), f.size, f.dtype.itemsize
            )[0]
            for f in stack
        ])
        nums = list(range(len(stack)))
        want = tproc.collect_batch(nums, tproc.dispatch_batch(stack), want_com=True)
        got = tproc.collect_batch(nums, tproc.dispatch_batch_planes(planes, dtype=dtype),
                                  want_com=True)
        for g, w in zip(got, want):
            _assert_same(g, w)
    with pytest.raises(ValueError, match="planes hold"):
        tproc.dispatch_batch_planes(planes[:, :1], dtype=np.uint32)


def test_batch_needs_the_kernel_path():
    stack, mask = synthetic_rotation_stack()
    h, w = stack.shape[1:]
    proc = SpotfindProcessor(w, h, mask, 65535.0, SpotfindConfig(precision="f32"), device=CPU)
    assert not proc.batch_supported()
    with pytest.raises(ValueError, match="kernel path"):
        proc.dispatch_batch(stack)


@pytest.mark.parametrize("kf", [4096, 16])
@pytest.mark.parametrize("with_neighbors", [False, True])
def test_compact_from_pcw_segmented_matches_jax(with_neighbors, kf):
    """Both compactions on the same [pc | w32] rows: every output equal,
    slot for slot (so the tall pitch, the padding, the per-frame counts and
    the neighbour slots, overflowing frames included)."""
    stack, mask = synthetic_rotation_stack()
    images = torch.from_numpy(stack)
    pcw = tp.dispersion_packed_raw(images, torch.from_numpy(mask), 65535.0)
    want = jcomp.compact_from_pcw_segmented(
        jnp.asarray(stack), jnp.asarray(pcw.numpy()), max_pixels_per_frame=kf,
        with_neighbors=with_neighbors,
    )
    got = tcomp.compact_from_pcw_segmented(images, pcw, max_pixels_per_frame=kf,
                                           with_neighbors=with_neighbors)
    (gp, *g_rest), (wp, *w_rest) = got, want
    for g, w in zip(gp, wp):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for g, w in zip(g_rest, w_rest):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    counts = got[-1].numpy()
    assert counts.sum() == int(gp.count) > 0
    assert (counts > kf).any() == (kf == 16)
    h = pcw.shape[1]
    for b, n in enumerate(counts):  # each frame's slice: tall indices of frame b
        lin = gp.linear_index[b * kf : b * kf + min(n, kf)].numpy()
        assert (lin // stack.shape[2] // (h + 1) == b).all()
    with pytest.raises(ValueError, match="too tall"):
        tcomp.compact_from_pcw_segmented(  # 40 Eiger 16M frames, as views of one zero
            torch.zeros((), dtype=torch.uint16).expand(40, 4362, 4148),
            torch.zeros((), dtype=torch.int32).expand(40, 4362, 2 * 136),
        )


# ---------------------------------------------------------------------------
# the CLI: --precision f32 --batch 4 [--decode-backend device]
# ---------------------------------------------------------------------------


def _env(extra):
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "FFS_TORCH_DEVICE": "cpu"}, **extra)
    return env


def _run_cli(package, args, cwd, extra):
    cwd.mkdir()
    r, w = os.pipe()
    os.set_inheritable(w, True)
    proc = subprocess.run(
        [sys.executable, "-m", f"{package}.pipeline.spotfinder", *args, "--pipe_fd", str(w)],
        capture_output=True, cwd=cwd, env=_env(extra), pass_fds=(w,), timeout=600,
    )
    os.close(w)
    with os.fdopen(r) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    log = proc.stdout.decode()
    assert proc.returncode == 0, log + proc.stderr.decode()
    return log, lines


def _h5(path):
    import h5py

    with h5py.File(path) as f:
        g = f["dials/processing/group_0"]
        return {k: g[k][()] for k in g}


@pytest.fixture(scope="module")
def bshuf_nexus(tmp_path_factory):
    stack, mask = synthetic_rotation_stack()
    path = tmp_path_factory.mktemp("nxs") / "rot.nxs"
    write_nexus(path, stack, oscillation=(0.0, 0.1), mask=mask, compression="bshuf")
    return path


@pytest.fixture(scope="module")
def shm_dir(tmp_path_factory):
    """A /dev/shm-style stream dump (the recipe of
    tests/test_spotfinder_cli_shm.py), as a rotation with a masked band."""
    d = tmp_path_factory.mktemp("shm")
    stack, mask = synthetic_rotation_stack(nimg=5, seed=11)
    header = {
        "nimages": len(stack), "ntrigger": 1, "y_pixels_in_detector": stack.shape[1],
        "x_pixels_in_detector": stack.shape[2], "bit_depth_image": 16,
        "countrate_correction_count_cutoff": 65530, "wavelength": 0.9762,
        "detector_distance": 250.0, "y_pixel_size": 7.5e-05, "x_pixel_size": 7.5e-05,
        "beam_center_y": 48.5, "beam_center_x": 64.5, "omega_start": 0.0,
        "omega_increment": 0.1,
    }
    (d / "start_1").write_text(json.dumps(header))
    (d / "start_4").write_text("{}")
    (d / "start_5").write_bytes((mask == 0).astype(np.int32).tobytes())
    for i, frame in enumerate(stack):
        (d / f"image_{i:06d}_2").write_bytes(compression.bshuf_lz4_compress(frame, 2))
    return d


@pytest.mark.parametrize("decode", ["host", "device"])
@pytest.mark.parametrize("source", ["nexus", "shm"])
def test_cli_batch_matches_jax(source, decode, bshuf_nexus, shm_dir, tmp_path):
    path = bshuf_nexus if source == "nexus" else shm_dir
    args = [str(path), "--precision", "f32", "--batch", "4", "--save-h5", "--min-spot-size",
            "1", "--decode-backend", decode]
    j_log, j_lines = _run_cli("ffs_tpu", args, tmp_path / "jax", {"FFS_PALLAS_INTERPRET": "1"})
    trace = tmp_path / "trace"
    t_log, t_lines = _run_cli("ffs_tpu_torch", args + ["--jax-profile", str(trace)],
                              tmp_path / "torch", {"FFS_TORCH_KERNEL_PATH": "1"})
    assert "Device: cpu" in t_log
    for log in (j_log, t_log):
        assert "unavailable" not in log, log
    assert t_lines == j_lines and len(j_lines) > 0
    assert [ln for ln in t_log.splitlines() if COUNT_LINE.match(ln)] == [
        ln for ln in j_log.splitlines() if COUNT_LINE.match(ln)]
    j_h5, t_h5 = _h5(tmp_path / "jax" / "results_ffs.h5"), _h5(tmp_path / "torch" / "results_ffs.h5")
    assert sorted(t_h5) == sorted(j_h5) and len(j_h5["xyzobs.px.value"]) > 0
    for name, want in j_h5.items():
        np.testing.assert_array_equal(t_h5[name], want, err_msg=name)
    assert (trace / "trace.json").stat().st_size > 0
