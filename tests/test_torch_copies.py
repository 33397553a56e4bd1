"""The port's copies of ffs_tpu's NumPy-only modules against the originals,
on the same seeded inputs: the division-form threshold oracle
(``ops/reference_division.py``) and the Eiger module split and join
(``io/modules.py``).  Tolerance: none, every array equal.
"""

import numpy as np
import pytest

from ffs_tpu.io import modules as jmod
from ffs_tpu.ops import reference_division as jdiv
from ffs_tpu_torch.io import modules as tmod
from ffs_tpu_torch.ops import reference_division as tdiv
from ffs_tpu_torch.ops.reference import erosion

TRUSTED = 65535.0


def _frame(seed, h=96, w=128, lam=30.0):
    rng = np.random.default_rng(seed)
    image = rng.poisson(lam, size=(h, w)).astype(np.uint16)
    for y, x in rng.integers(3, min(h, w) - 3, size=(12, 2)):
        image[y - 1 : y + 2, x - 1 : x + 2] += rng.poisson(8 * lam, size=(3, 3)).astype(np.uint16)
    image[rng.random((h, w)) < 0.01] = 65535  # past trusted_max
    mask = (rng.random((h, w)) > 0.03).astype(np.uint8)
    return image, mask


def _division(mod, seed):
    image, mask = _frame(seed, lam=[4.0, 30.0, 3000.0][seed % 3])
    first = mod.dispersion_extended_first_pass_division_f32(image, mask, TRUSTED)
    return [
        mod.dispersion_division_f32(image, mask, TRUSTED),
        mod.dispersion_division_f32(image, mask, TRUSTED, min_count=5, nsig_b=4.0, nsig_s=2.5),
        first,
        mod.dispersion_extended_second_pass_division_f32(image, mask, erosion(first, mask),
                                                         TRUSTED),
        mod.dispersion_extended_division_f32(image, mask, TRUSTED),
    ]


def _modules(mod, seed):
    rng = np.random.default_rng(seed)
    out = []
    for detector, (h, w) in (("16M", (4362, 4148)), ("4M", (2162, 2068))):
        image = rng.integers(0, 65536, size=(h, w), dtype=np.uint16)
        stacked = mod.image_modules(image, detector)
        out += [stacked, mod.modules_to_image(stacked, detector)]
    out.append(np.frombuffer(mod.draw_image_data(image, 7, 11, 6, 4).encode(), np.uint8))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", ["reference_division", "io_modules"])
def test_copy_matches_ffs_tpu(case, seed):
    fn, port, jax_side = {"reference_division": (_division, tdiv, jdiv),
                          "io_modules": (_modules, tmod, jmod)}[case]
    got, want = fn(port, seed), fn(jax_side, seed)
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=f"output {k}")
    if case == "reference_division":
        assert got[0].any()  # the spots are found: not an all-False comparison
