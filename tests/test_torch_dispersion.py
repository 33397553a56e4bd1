"""ffs_tpu_torch.ops.dispersion / masking against ffs_tpu (bit-exact).

The same numpy inputs go through the JAX functions (CPU, x64 on, as the
suite's conftest sets) and their PyTorch counterparts on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffs_tpu.ops import dispersion as jd
from ffs_tpu.ops import masking as jm
from ffs_tpu_torch.ops import dispersion as td
from ffs_tpu_torch.ops import masking as tmask

TM = 65535.0
DTYPES = [(jnp.float64, torch.float64), (jnp.float32, torch.float32)]


@pytest.fixture(scope="module")
def sample_crops():
    """~512 x 600 crops of sample images 2 and 5 spanning a module-gap
    corner (gap rows 512-549, gap columns 1028-1039)."""
    from ffs_tpu.io import sample_data

    mask = sample_data.generate_mask()[300:812, 800:1400]
    return {
        idx: (sample_data.generate_sample_image(idx)[300:812, 800:1400].copy(), mask.copy())
        for idx in (2, 5)
    }


def _frames(small_frame, sample_crops):
    return [("small", *small_frame), ("sample2", *sample_crops[2]), ("sample5", *sample_crops[5])]


@pytest.mark.parametrize("radius", [2, 3, 5])
def test_box_sum_tree_order(radius):
    """Non-integer f32 grids round: equality pins the canonical tree order."""
    rng = np.random.default_rng(radius)
    x = (rng.random((2, 45, 70)) * 1000).astype(np.float32)
    want = np.asarray(jd.box_sum(jnp.asarray(x), radius))
    got = td.box_sum(torch.from_numpy(x), radius).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("fn", ["dispersion", "dispersion_first_pass", "dispersion_extended"])
def test_dispersion_functions(small_frame, sample_crops, fn, jdt, tdt):
    for name, image, mask in _frames(small_frame, sample_crops):
        want = np.asarray(getattr(jd, fn)(jnp.asarray(image), jnp.asarray(mask), TM, dtype=jdt))
        got = getattr(td, fn)(torch.from_numpy(image), torch.from_numpy(mask), TM, dtype=tdt)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        if name == "sample2":
            assert want.sum() > 0


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_erode_and_second_pass(small_frame, sample_crops, jdt, tdt):
    for name, image, mask in _frames(small_frame, sample_crops):
        first = np.array(jd.dispersion_first_pass(jnp.asarray(image), jnp.asarray(mask), TM, dtype=jdt))
        surv_j = np.array(jd.erode(jnp.asarray(first), jnp.asarray(mask)))
        surv_t = td.erode(torch.from_numpy(first), torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(surv_t, surv_j, err_msg=name)
        want = np.asarray(
            jd.dispersion_second_pass(jnp.asarray(image), jnp.asarray(mask), jnp.asarray(surv_j), TM, dtype=jdt)
        )
        got = td.dispersion_second_pass(
            torch.from_numpy(image), torch.from_numpy(mask), torch.from_numpy(surv_t), TM, dtype=tdt
        ).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_u32_sentinels(jdt, tdt):
    """u32 values >= 2^31 widen by value: sentinels fail trusted_max in both."""
    rng = np.random.default_rng(4)
    image = rng.integers(0, 100, size=(64, 96)).astype(np.uint32)
    image[10, 50] = 0xFFFFFFFF
    image[50, 20] = 2**31 + 1
    image[28:35, 40:47] = 16777217  # rounds in f32
    mask = np.ones(image.shape, np.uint8)
    for fn in ("dispersion", "dispersion_extended"):
        want = np.asarray(getattr(jd, fn)(jnp.asarray(image), jnp.asarray(mask), TM, dtype=jdt))
        got = getattr(td, fn)(torch.from_numpy(image), torch.from_numpy(mask), TM, dtype=tdt)
        np.testing.assert_array_equal(got.numpy(), want)
        assert not want[10, 50] and not want[50, 20]


@pytest.mark.parametrize("dmin,dmax", [(3.0, -1.0), (-1.0, 2.5), (2.0, 4.0)])
def test_resolution_mask(dmin, dmax):
    h, w = 96, 128
    mask = np.ones((h, w), np.uint8)
    mask[40:44] = 0
    geom = dict(
        wavelength=0.976, distance=0.05, beam_center_x=60.3, beam_center_y=41.7,
        pixel_size_x=75e-6 * 8, pixel_size_y=75e-6 * 8,
    )
    want = np.asarray(jm.resolution_mask(jnp.asarray(mask), dmin=dmin, dmax=dmax, **geom))
    got = tmask.resolution_mask(torch.from_numpy(mask), dmin=dmin, dmax=dmax, **geom).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < mask.sum()
