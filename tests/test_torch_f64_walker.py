"""The float64 walker route of the spotfinder's default step, on the CPU.

``SpotfindProcessor._step`` sends the float64 ``dispersion`` threshold of a
uint16 frame through ``ops.dispersion_packed.dispersion_packed_f64`` (on
the CPU its plain version: ``ops.dispersion`` in float64, then
``pack_pcw``) and compacts from the packed words with the vertical
neighbour slots.  Each case holds that route, bit for bit, to the dense
route it replaced (the float64 threshold, ``compact_strong_pixels``,
labels by binary search) and to ``ffs_tpu``'s float64 step: pixels, roots,
the float64 spot table, ``both_keep``, ``n_boxes`` and ``n_px_filtered``.
The route rule is held through the CLI: ``f64_walker_frames`` counts every
frame of a float64 ``dispersion`` run over uint16 frames and none of the
others.
"""

import copy
import json
import pathlib

import numpy as np
import pytest
import torch

from ffs_tpu import spotfind as jsf
from ffs_tpu_torch import spotfind as tsf
from ffs_tpu_torch.io import compression
from ffs_tpu_torch.ops import connected_components as cc
from ffs_tpu_torch.ops import dispersion as dops
from ffs_tpu_torch.ops import dispersion_packed as tp
from ffs_tpu_torch.utils import tracing
from ffsbench import frames as bench_frames

from .test_torch_batch import _run_cli, shm_dir  # noqa: F401  (a fixture)
from .test_torch_tracing import _ffs_trace
from .util import synthetic_rotation_stack

CPU = torch.device("cpu")
BENCH_DIR = pathlib.Path(__file__).resolve().parents[1] / "ffsbench"
TM = 65530.0  # the Eiger configuration's trusted maximum: 65531-65535 are untrusted


def _bench_frame():
    """Two frames of the benchmark's Eiger traffic on a 204 x 232 detector of
    3 x 2 modules (gaps masked, the last rows and columns outside every
    module), spots on every module."""
    cfg = json.loads((BENCH_DIR / "configs" / "eiger16m-rotation-f64.json").read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / "rotation300.catchup.json").read_text())
    det = cfg["detector"]
    det.update(height=204, width=232)
    det["mask"].update(module=[62, 110], gap=[6, 6], grid=[3, 2])
    traffic = copy.deepcopy(traffic)
    traffic["distinct_frames"] = 2
    traffic["spots"]["count"] = 40
    stack = bench_frames.make_frames(cfg, traffic, 2**31 + 23, CPU).numpy()
    return stack, bench_frames.detector_mask(det)


def _saturated_frame():
    """Bright spots whose cores sit at and above the trusted maximum (65530):
    window sums of squares near 49 * 65535^2, pixels that pass every test but
    the trusted one."""
    rng = np.random.default_rng(5)
    h, w = 96, 128
    image = rng.poisson(40.0, size=(h, w)).astype(np.int64)
    for k, (y, x) in enumerate(zip(rng.integers(4, h - 4, 24), rng.integers(4, w - 4, 24))):
        image[y - 1 : y + 2, x - 1 : x + 2] += 20000 + 1500 * (k % 4)
        image[y, x] = 65525 + k % 11  # 65525 .. 65535, around the trusted maximum
    image[10:17, 10:17] = 65535  # a saturated block: every window sum at its largest
    return np.clip(image, 0, 65535).astype(np.uint16), np.ones((h, w), np.uint8)


def _gaps_edges_frame():
    """Spots on the frame's edges and corners and against masked module
    gaps (rows and columns), where the zero padding and the mask decide the
    window counts."""
    rng = np.random.default_rng(9)
    h, w = 100, 131
    image = rng.poisson(3.0, size=(h, w)).astype(np.uint16)
    mask = np.ones((h, w), np.uint8)
    mask[47:51] = 0
    mask[:, 64:67] = 0
    mask[0, :20] = 0
    spots = [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (1, 60), (h - 2, 90), (50, 10),
             (46, 30), (51, 100), (20, 63), (70, 67), (46, 63), (51, 67), (30, w - 2), (80, 1)]
    for y, x in spots:
        image[max(y - 1, 0) : y + 2, max(x - 1, 0) : x + 2] += np.uint16(600)
    image[mask == 0] = 0
    return image, mask


def _near_threshold_frame():
    """A flat field whose variance sits at the variance test's threshold (a
    dispersion index of ~2.2 at a mean of 30000): a few pixels fall within
    the float32 rounding of it, where the float32 threshold decides
    otherwise than the float64 one."""
    rng = np.random.default_rng(0)
    mean = 30000.0
    image = rng.normal(mean, np.sqrt(2.2 * mean), size=(128, 160))
    return np.clip(np.rint(image), 0, 65535).astype(np.uint16), np.ones((128, 160), np.uint8)


def _frames(name):
    """(list of u16 frames, mask) of one case."""
    if name == "ffsbench":
        stack, mask = _bench_frame()
        return list(stack), mask
    image, mask = {"saturated": _saturated_frame, "gaps_edges": _gaps_edges_frame,
                   "near_threshold": _near_threshold_frame}[name]()
    return [image], mask


CASES = ["ffsbench", "saturated", "gaps_edges", "near_threshold"]


def _processors(shape, mask, **kw):
    kw = {"min_spot_size": 2, **kw}
    h, w = shape
    jcfg = jsf.SpotfindConfig(**kw)
    tcfg = tsf.SpotfindConfig(**kw)
    return (jsf.SpotfindProcessor(w, h, mask, TM, jcfg),
            tsf.SpotfindProcessor(w, h, mask, TM, tcfg, device=CPU))


def _dense_step(proc, image):
    """The float64 step as it was before the walker route: the dense
    threshold, ``compact_strong_pixels`` and labels whose vertical
    neighbours come from a binary search."""
    cfg = proc.config
    f64 = torch.float64
    strong = dops.dispersion(image, proc.mask, proc.trusted_max, min_count=cfg.min_count,
                             nsig_b=cfg.nsig_b, nsig_s=cfg.nsig_s, dtype=f64)
    pixels = cc.compact_strong_pixels(strong, image, max_pixels=cfg.max_strong_pixels)
    root_slot = cc.label_compact_pixels(pixels, width=proc.width)
    root_lin = pixels.linear_index[root_slot.to(torch.int64)]
    table = cc.spot_table_from_pixels(pixels, root_slot, width=proc.width,
                                      max_spots=cfg.max_spots, dtype=f64)
    size_keep = cc.filter_spots(table, cfg.min_spot_size, -1.0, dtype=f64)[0]
    both_keep = cc.filter_spots(table, cfg.min_spot_size, cfg.max_peak_centroid_separation,
                                dtype=f64)[0]
    n_boxes = size_keep.sum(dtype=torch.int32)
    n_px_filtered = torch.where(size_keep, table.n_pixels, 0).sum(dtype=torch.int32)
    return pixels, root_lin, table, both_keep, n_boxes, n_px_filtered


def _arrays(step):
    """A step's outputs as named NumPy arrays (torch or JAX)."""
    pixels, root_lin, table, both_keep, n_boxes, n_px_filtered = step
    out = {f"pixels.{k}": np.asarray(getattr(pixels, k)) for k in pixels._fields}
    out.update({f"table.{k}": np.asarray(getattr(table, k)) for k in table._fields})
    out.update(root_lin=np.asarray(root_lin), both_keep=np.asarray(both_keep),
               n_boxes=np.asarray(n_boxes), n_px_filtered=np.asarray(n_px_filtered))
    return out


def _assert_bit_equal(got, want, same_int_width=True):
    """Every output equal bit for bit: floats of the same type with the same
    bytes; integers of the same width, or (JAX under x64, whose counts are
    int64) of the same values."""
    got, want = _arrays(got), _arrays(want)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = want[name]
        if same_int_width or g.dtype.kind == "f":
            assert g.dtype == w.dtype, name
            assert g.tobytes() == w.tobytes(), name
        else:
            assert g.dtype.kind == w.dtype.kind and np.array_equal(g, w), name


@pytest.mark.parametrize("case", CASES)
def test_walker_route_is_bit_equal_to_dense_route_and_jax(case):
    frames, mask = _frames(case)
    jproc, tproc = _processors(frames[0].shape, mask)
    assert tproc._f64_walker and not tproc.use_kernel and not tproc.host_cc
    rec = tracing.start(False)
    for frame in frames:
        got = tproc.dispatch(frame)
        img = torch.from_numpy(frame)
        _assert_bit_equal(got, _dense_step(tproc, img))
        _assert_bit_equal(got, jproc.dispatch(frame), same_int_width=False)
        assert int(got[0].count) > 0 and int(got[4]) > 0
    assert rec.counts["f64_walker_frames"] == len(frames)
    tracing.start(False)


@pytest.mark.parametrize("case", CASES)
def test_walker_words_are_the_float64_threshold(case):
    """The packed words of the route are the float64 threshold's strong
    plane bit for bit; on the near-threshold frame the float32 walker's
    plain version gives another strong set."""
    frames, mask = _frames(case)
    img, msk = torch.from_numpy(np.stack(frames)), torch.from_numpy(mask)
    pcw = tp.dispersion_packed_f64(img, msk, TM)
    strong64 = dops.dispersion(img, msk, TM, dtype=torch.float64)
    assert torch.equal(pcw, tp.pack_pcw(strong64, tp.nwl_for_width(img.shape[-1])))
    assert torch.equal(tp.dispersion_packed_f64(img[0], msk, TM), pcw[0])
    f32 = tp.dispersion_packed_plain(img, msk, TM)
    if case == "near_threshold":
        strong32 = dops.dispersion(img, msk, TM, dtype=torch.float32)
        assert 0 < int((strong32 != strong64).sum()) < 10
        assert not torch.equal(pcw, f32)
    if case == "saturated":  # the trusted gate keeps the brightest cores out
        assert int((strong64 & (img > TM)).sum()) == 0
        assert int((img > TM).sum()) > 0


def test_walker_takes_only_uint16():
    image, mask = _gaps_edges_frame()
    with pytest.raises(TypeError, match="uint16"):
        tp.dispersion_packed_f64(torch.from_numpy(image.astype(np.int32)),
                                 torch.from_numpy(mask), TM)


def _overflow_frame(h=256, w=320):
    """Isolated bright pixels everywhere -> ~1200 strong single-pixel spots."""
    image = np.zeros((h, w), dtype=np.uint16)
    image[4:-4:8, 4:-4:8] = 500
    return image, np.ones((h, w), dtype=np.uint8)


@pytest.mark.parametrize("cc_backend", ["device", "host"])
def test_capacity_overflow_raises_as_the_dense_route(cc_backend):
    """Past ``max_strong_pixels`` the walker route (u16) raises the error of
    the dense route (the same values as int32 pixels, which keep it) and
    of ``ffs_tpu``."""
    image, mask = _overflow_frame()
    kw = dict(max_strong_pixels=64, max_spots=256, min_spot_size=1, cc_backend=cc_backend)
    jproc, tproc = _processors(image.shape, mask, **kw)
    messages = []
    for proc, frame in ((tproc, image), (tproc, image.astype(np.int32)), (jproc, image)):
        with pytest.raises(RuntimeError, match="exceed the") as err:
            proc.process_frame(0, frame)
        messages.append(str(err.value))
    assert messages[0] == messages[1] == messages[2]


@pytest.fixture(scope="module")
def shm_dir32(tmp_path_factory):
    """``shm_dir``'s stream with 32-bit pixels (``bit_depth_image`` 32)."""
    d = tmp_path_factory.mktemp("shm32")
    stack, mask = synthetic_rotation_stack(nimg=3, seed=11)
    header = {
        "nimages": len(stack), "ntrigger": 1, "y_pixels_in_detector": stack.shape[1],
        "x_pixels_in_detector": stack.shape[2], "bit_depth_image": 32,
        "countrate_correction_count_cutoff": 65530, "wavelength": 0.9762,
        "detector_distance": 250.0, "y_pixel_size": 7.5e-05, "x_pixel_size": 7.5e-05,
        "beam_center_y": 48.5, "beam_center_x": 64.5, "omega_start": 0.0,
        "omega_increment": 0.1,
    }
    (d / "start_1").write_text(json.dumps(header))
    (d / "start_4").write_text("{}")
    (d / "start_5").write_bytes((mask == 0).astype(np.int32).tobytes())
    for i, frame in enumerate(stack.astype(np.uint32)):
        (d / f"image_{i:06d}_2").write_bytes(compression.bshuf_lz4_compress(frame, 4))
    return d


ROUTES = {  # CLI flags -> the walker takes every frame
    "f64": ([], True),
    "f64_extended": (["--algorithm", "dispersion_extended"], False),
    "f32": (["--precision", "f32"], False),
    "f64_u32": (["--pixel-depth", "32"], False),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_cli_counts_walker_frames_by_the_route_rule(route, shm_dir, shm_dir32,  # noqa: F811
                                                    tmp_path):
    flags, walker = ROUTES[route]
    source = shm_dir32 if route == "f64_u32" else shm_dir
    log, lines = _run_cli("ffs_tpu_torch", [str(source), "--threads", "2", *flags],
                          tmp_path / "run", {})
    rep = _ffs_trace(log)
    c = rep["counters"]
    assert c["frames_in"] == len(lines) > 0
    assert c["f64_walker_frames"] == (c["frames_in"] if walker else 0)
    assert rep["launches"]["dispersion_packed_f64"] == 0  # the CPU runs the plain version
