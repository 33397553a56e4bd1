"""ffs_tpu_torch.spotfind.SpotfindProcessor against ffs_tpu's, frame for frame.

Each case builds the JAX configuration, then the port's through
``config_from_dict(dataclasses.asdict(...))``, runs the same numpy frames
through both processors on the CPU and compares every FrameResult field.
The JAX kernel path runs its Pallas kernels in interpret mode; the port's
``use_kernel=True`` takes the kernels' plain versions on the CPU.
Centroids from the float64 device CC are compared at rtol=1e-12 (ratios of
segment sums whose reduction order torch and XLA may choose differently);
everything else is bit-exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ffs_tpu import spotfind as jsf
from ffs_tpu_torch import spotfind as tsf

CPU = torch.device("cpu")
TM = 65535.0

CASES = {
    "f64-device-cc": dict(),
    "f64-host-cc": dict(cc_backend="host"),
    "f64-extended": dict(algorithm="dispersion_extended"),
    "f32-plain-device-cc": dict(precision="f32", use_pallas=False),
    "f32-kernel-tiered": dict(precision="f32", use_pallas=True),
    "f32-kernel-tiered-extended": dict(
        precision="f32", use_pallas=True, algorithm="dispersion_extended"
    ),
    "f32-kernel-device-cc": dict(precision="f32", use_pallas=True, cc_backend="device"),
}


def _processors(image_shape, mask, **kw):
    kw.setdefault("min_spot_size", 2)
    jcfg = jsf.SpotfindConfig(**kw)
    if jcfg.use_pallas:
        jcfg.pallas_interpret = True
    tcfg = tsf.config_from_dict(dataclasses.asdict(jcfg))
    h, w = image_shape
    return (
        jsf.SpotfindProcessor(w, h, mask, TM, jcfg),
        tsf.SpotfindProcessor(w, h, mask, TM, tcfg, device=CPU),
    )


def _frames(small_frame):
    image, mask = small_frame
    rng = np.random.default_rng(3)
    busy = image.copy()
    ys, xs = rng.integers(10, 246, 60), rng.integers(10, 310, 60)
    for y, x in zip(ys, xs):
        busy[y : y + 2, x : x + 3] += np.uint16(400)
    busy[mask == 0] = 0
    return [image, busy], mask


def _assert_results_equal(got, want, com_rtol):
    for name in ("image_number", "n_strong_pixels", "n_spots", "n_spots_prefilter",
                 "n_strong_pixels_filtered"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("linear_index", "intensity", "root"):
        g = np.asarray(getattr(got.pixels, name))
        w = np.asarray(getattr(want.pixels, name))
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=name)
    assert got.centers_of_mass.shape == want.centers_of_mass.shape
    if com_rtol:
        np.testing.assert_allclose(got.centers_of_mass, want.centers_of_mass, rtol=com_rtol, atol=0)
    else:
        np.testing.assert_array_equal(got.centers_of_mass, want.centers_of_mass)


@pytest.mark.parametrize("case", list(CASES))
def test_processor_matches_jax(small_frame, case):
    frames, mask = _frames(small_frame)
    jproc, tproc = _processors(frames[0].shape, mask, **CASES[case])
    assert tproc.use_kernel == bool(jproc.config.pallas_enabled())
    assert tproc.host_cc == jproc.host_cc and not jproc.host_compact
    com_rtol = 1e-12 if (not tproc.host_cc and tproc.config.precision == "f64") else 0
    for num, frame in enumerate(frames):
        want = jproc.process_frame(num, frame, want_com=True)
        got = tproc.process_frame(num, frame, want_com=True)
        assert isinstance(got, tsf.FrameResult)
        _assert_results_equal(got, want, com_rtol)
        assert got.n_strong_pixels > 0 and len(got.centers_of_mass) > 0


@pytest.mark.parametrize("case", ["f64-device-cc", "f32-kernel-tiered"])
def test_profiled_matches_plain_dispatch(small_frame, case):
    frames, mask = _frames(small_frame)
    jproc, tproc = _processors(frames[0].shape, mask, **CASES[case])
    got, timings = tproc.process_frame_profiled(7, frames[1])
    _, jtimings = jproc.process_frame_profiled(7, frames[1])
    assert list(timings) == list(jtimings)
    assert all(v >= 0 for v in timings.values())
    _assert_results_equal(got, tproc.process_frame(7, frames[1]), 0)


def _overflow_frame(h=256, w=320):
    """Isolated bright pixels everywhere -> ~1200 strong single-pixel spots."""
    image = np.zeros((h, w), dtype=np.uint16)
    image[4:-4:8, 4:-4:8] = 500
    return image, np.ones((h, w), dtype=np.uint8)


@pytest.mark.parametrize("case", ["f64-device-cc", "f64-host-cc", "f32-kernel-tiered",
                                  "f32-kernel-device-cc"])
def test_capacity_overflow_hard_fails(case):
    image, mask = _overflow_frame()
    kw = dict(CASES[case], max_strong_pixels=64, max_spots=256, min_spot_size=1)
    jproc, tproc = _processors(image.shape, mask, **kw)
    with pytest.raises(RuntimeError, match="exceed the"):
        jproc.process_frame(0, image)
    with pytest.raises(RuntimeError, match="exceed the"):
        tproc.process_frame(0, image)


def test_spot_overflow_hard_fails_device_cc():
    image, mask = _overflow_frame()
    kw = dict(CASES["f32-kernel-device-cc"], max_strong_pixels=4096, max_spots=256, min_spot_size=1)
    _, tproc = _processors(image.shape, mask, **kw)
    with pytest.raises(RuntimeError, match="exceed max_spots"):
        tproc.process_frame(0, image)


def test_capacity_tier_escalation():
    """~20k strong pixels pass the 4096 and 16384 tiers and compact at the
    configured maximum, equal to the JAX result."""
    image, mask = _overflow_frame()
    image[2:-2:2, 2:-2:2] = 500
    kw = dict(CASES["f32-kernel-tiered"], max_spots=32768, min_spot_size=1)
    jproc, tproc = _processors(image.shape, mask, **kw)
    assert tproc._capacity_tiers == [4096, 16384, 65536]
    got = tproc.process_frame(0, image)
    assert got.n_strong_pixels > 16384
    _assert_results_equal(got, jproc.process_frame(0, image), 0)


def test_config_round_trip_and_device_rules():
    jcfg = jsf.SpotfindConfig(precision="f32", use_pallas=True, pallas_interpret=True)
    tcfg = tsf.config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.use_kernel is True and not hasattr(tcfg, "pallas_interpret")
    with pytest.raises(ValueError, match="unknown"):
        tsf.config_from_dict({"bogus": 1})
    auto = tsf.SpotfindConfig(precision="f32")
    assert not auto.kernel_enabled(CPU)
    assert auto.kernel_enabled(torch.device("cuda", 0))
    assert not tsf.SpotfindConfig().kernel_enabled(torch.device("cuda", 0))
    image, mask = _overflow_frame()
    # the port compacts on the device only: ffs_tpu's default is accepted
    # (and dropped), its host compaction refused
    assert tcfg == tsf.config_from_dict({**dataclasses.asdict(jcfg), "compact_backend": "device"})
    with pytest.raises(ValueError, match="compact_backend='host'"):
        tsf.config_from_dict({**dataclasses.asdict(jcfg), "compact_backend": "host"})
    proc = tsf.SpotfindProcessor(320, 256, mask, TM, device=CPU)
    assert proc.batch_supported() is False
