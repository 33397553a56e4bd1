"""The packed [pc | w32] kernels' plain versions, compaction and host
compaction of ffs_tpu_torch against ffs_tpu (bit-exact).

The JAX side runs its Pallas kernels in interpret mode on the CPU, as its
own tests do; the port's wrappers take their plain PyTorch versions for CPU
tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffs_tpu.ops import compact as jcomp
from ffs_tpu.ops.compact_host import compact_pcw_host
from ffs_tpu.ops.dispersion_extended_pallas import (
    dispersion_extended_packed_raw as j_ext_raw,
)
from ffs_tpu.ops.dispersion_extended_pallas import (
    mask_box_count_extended as j_mbox_ext,
)
from ffs_tpu.ops.dispersion_pallas import dispersion_packed_raw as j_raw
from ffs_tpu.ops.dispersion_pallas import mask_box_count as j_mbox
from ffs_tpu_torch.ops import compact as tcomp
from ffs_tpu_torch.ops import dispersion_extended_packed as txp
from ffs_tpu_torch.ops import dispersion_packed as tp

TM = 65535.0


def _u32_frame():
    """u32 frame with saturation sentinels (the shape of
    tests/test_dispersion_pallas.py::test_packed_u32_saturation_matches_oracle)."""
    rng = np.random.default_rng(4)
    image = rng.integers(0, 100, size=(64, 256)).astype(np.uint32)
    image[10, 50] = 0xFFFFFFFF  # saturated sentinel, unmasked
    image[50, 200] = 2**31  # wraps negative under an i32 hop
    image[28:35, 98:105] = 5000  # a real spot nearby
    return image, np.ones((64, 256), np.uint8)


def _i32_frame():
    """CBF-like int32 frame: -1 in a masked gap row, one unmasked -2."""
    rng = np.random.default_rng(8)
    image = rng.poisson(20.0, size=(64, 160)).astype(np.int32)
    image[20:25, 60:66] += 3000
    mask = np.ones(image.shape, np.uint8)
    image[40], mask[40] = -1, 0
    image[10, 10] = -2
    return image, mask


FRAMES = {"u32": _u32_frame, "i32": _i32_frame}


def _jax_pcw(algorithm, image, mask, with_mbox):
    if algorithm == "dispersion":
        mbox = j_mbox(jnp.asarray(mask)) if with_mbox else None
        return np.asarray(j_raw(jnp.asarray(image), jnp.asarray(mask), TM, mbox=mbox, interpret=True))
    mbox = j_mbox_ext(jnp.asarray(mask)) if with_mbox else None
    return np.asarray(j_ext_raw(jnp.asarray(image), jnp.asarray(mask), TM, mbox=mbox, interpret=True))


def _torch_pcw(algorithm, image, mask, with_mbox):
    img, msk = torch.from_numpy(image), torch.from_numpy(mask)
    if algorithm == "dispersion":
        mbox = tp.mask_box_count(msk) if with_mbox else None
        return tp.dispersion_packed_raw(img, msk, TM, mbox=mbox).numpy()
    mbox = txp.mask_box_count_extended(msk) if with_mbox else None
    return txp.dispersion_extended_packed_raw(img, msk, TM, mbox=mbox).numpy()


@pytest.mark.parametrize("with_mbox", [False, True])
@pytest.mark.parametrize("pixels", ["u16", "u32", "i32"])
@pytest.mark.parametrize("algorithm", ["dispersion", "dispersion_extended"])
def test_packed_raw_matches_jax(small_frame, algorithm, pixels, with_mbox):
    image, mask = small_frame if pixels == "u16" else FRAMES[pixels]()
    want = _jax_pcw(algorithm, image, mask, with_mbox)
    got = _torch_pcw(algorithm, image, mask, with_mbox)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    nwl = got.shape[1] // 2
    assert got[:, nwl - 1].sum() > 0
    assert (got[:, nwl:] < 0).any() or pixels != "u16"  # bit 31 words occur


def test_packed_raw_batched_and_first_pass(small_frame):
    image, mask = small_frame
    batch = np.stack([image, np.roll(image, 9, axis=1)])
    want = np.asarray(
        j_raw(jnp.asarray(batch), jnp.asarray(mask), TM, signal_test=False, interpret=True)
    )
    got = tp.dispersion_packed_raw(
        torch.from_numpy(batch), torch.from_numpy(mask), TM, signal_test=False
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_mask_box_counts(small_frame):
    _, mask = small_frame
    h, w = mask.shape
    got = tp.mask_box_count(torch.from_numpy(mask))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_mbox(jnp.asarray(mask))))
    # the JAX extended count lives on a padded strip canvas (row halo 16,
    # column offset 10); the port keeps the frame grid
    canvas = np.asarray(j_mbox_ext(jnp.asarray(mask)))
    ext = txp.mask_box_count_extended(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(ext, canvas[16 : 16 + h, 10 : 10 + w])
    bad = torch.zeros((h + 1, w), dtype=torch.uint16)
    with pytest.raises(ValueError, match="mbox shape"):
        txp.dispersion_extended_packed_raw(
            torch.from_numpy(small_frame[0]), torch.from_numpy(mask), TM, mbox=bad
        )


def test_pack_pcw_contract():
    rng = np.random.default_rng(11)
    strong = rng.random((5, 70)) < 0.3
    strong[2, 31] = strong[2, 63] = True  # bit 31 set: negative i32 words
    nwl = tp.nwl_for_width(70)
    pcw = tp.pack_pcw(torch.from_numpy(strong), nwl).numpy()
    words = pcw[:, nwl:].astype(np.int64) & 0xFFFFFFFF
    bits = (words[:, :, None] >> np.arange(32)) & 1
    np.testing.assert_array_equal(bits.reshape(5, -1)[:, :70], strong)
    assert not bits.reshape(5, -1)[:, 70:].any()
    np.testing.assert_array_equal(pcw[:, :nwl], np.cumsum(bits.sum(axis=2), axis=1))


@pytest.mark.parametrize("with_neighbors", [False, True])
@pytest.mark.parametrize("algorithm", ["dispersion", "dispersion_extended"])
def test_compact_from_pcw_matches_jax(small_frame, algorithm, with_neighbors):
    image, mask = small_frame
    pcw = _torch_pcw(algorithm, image, mask, True)
    want = jcomp.compact_from_pcw(
        jnp.asarray(image), jnp.asarray(pcw), max_pixels=1024, with_neighbors=with_neighbors
    )
    got = tcomp.compact_from_pcw(
        torch.from_numpy(image), torch.from_numpy(pcw), max_pixels=1024,
        with_neighbors=with_neighbors,
    )
    if not with_neighbors:
        want, got = (want,), (got,)
    assert int(got[0].count) == int(want[0].count) > 0
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_compact_from_pcw_overflow_keeps_exact_count(small_frame):
    image, mask = small_frame
    pcw = _torch_pcw("dispersion_extended", image, mask, False)
    k = 16
    want = jcomp.compact_from_pcw(jnp.asarray(image), jnp.asarray(pcw), max_pixels=k)
    got = tcomp.compact_from_pcw(torch.from_numpy(image), torch.from_numpy(pcw), max_pixels=k)
    assert int(got.count) == int(want.count) > k
    np.testing.assert_array_equal(got.linear_index.numpy(), np.asarray(want.linear_index))
    np.testing.assert_array_equal(got.intensity.numpy(), np.asarray(want.intensity))


@pytest.mark.parametrize("pixels", ["u16", "u32", "i32"])
def test_compact_pcw_host_on_port_pcw(small_frame, pixels):
    """The shared host compaction reads the port's rows like the JAX ones."""
    image, mask = small_frame if pixels == "u16" else FRAMES[pixels]()
    pcw_t = _torch_pcw("dispersion", image, mask, True)
    pcw_j = _jax_pcw("dispersion", image, mask, True)
    lin_t, inten_t = compact_pcw_host(pcw_t, image, image.shape[1])
    lin_j, inten_j = compact_pcw_host(pcw_j, image, image.shape[1])
    np.testing.assert_array_equal(lin_t, lin_j)
    np.testing.assert_array_equal(inten_t, inten_j)
    dev = tcomp.compact_from_pcw(torch.from_numpy(image), torch.from_numpy(pcw_t), max_pixels=8192)
    n = int(dev.count)
    assert n == len(lin_t) > 0
    np.testing.assert_array_equal(dev.linear_index[:n].numpy(), lin_t)
    np.testing.assert_array_equal(dev.intensity[:n].numpy(), inten_t)
