"""Compaction, connected components, spot tables and filters of
ffs_tpu_torch against ffs_tpu's device CC.

Bit-exact throughout, with one stated exception: the float64 centroids
com_x/com_y are checked at rtol=1e-12, because they are ratios of segment
sums and torch and XLA are free to reduce a segment in a different order
(on the CPU both happen to add in slot order, so they agree exactly here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffs_tpu.ops import compact as jcomp
from ffs_tpu.ops import connected_components as jcc
from ffs_tpu_torch.ops import compact as tcomp
from ffs_tpu_torch.ops import connected_components as tcc
from ffs_tpu_torch.ops import dispersion_packed as tp

K = 8192
MAX_SPOTS = 4096


def _dense_frame():
    """Many spots: a 30% random strong mask (percolating, branched
    clusters) plus a serpentine that needs many propagation rounds."""
    rng = np.random.default_rng(123)
    h, w = 96, 128
    strong = rng.random((h, w)) < 0.3
    strong[:, 100:] = False
    for r in range(0, h, 4):  # serpentine in columns 102..125
        strong[r, 102:126] = True
        strong[r : r + 4, 125 if (r // 4) % 2 == 0 else 102] = True
    image = rng.integers(1, 60000, size=(h, w)).astype(np.uint16)
    image[5, 5] = image[5, 6] = 70  # a peak tie
    return strong, image


def _strong_small(small_frame):
    from ffs_tpu_torch.ops import dispersion as td

    image, mask = small_frame
    strong = td.dispersion_extended(torch.from_numpy(image), torch.from_numpy(mask), 65535.0)
    return strong.numpy(), image


@pytest.fixture(params=["small", "dense"])
def frame(request, small_frame):
    return _strong_small(small_frame) if request.param == "small" else _dense_frame()


def _both_compact(strong, image):
    jp = jcc.compact_strong_pixels(jnp.asarray(strong), jnp.asarray(image), max_pixels=K)
    tpx = tcc.compact_strong_pixels(torch.from_numpy(strong), torch.from_numpy(image), max_pixels=K)
    return jp, tpx


def test_compact_strong_pixels(frame):
    strong, image = frame
    jp, tpx = _both_compact(strong, image)
    assert int(tpx.count) == int(jp.count) == int(strong.sum()) > 0
    for g, w in zip(tpx, jp):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("neighbours", ["search", "packed"])
def test_label_compact_pixels(frame, neighbours):
    strong, image = frame
    w = strong.shape[1]
    if neighbours == "search":
        jp, tpx = _both_compact(strong, image)
        want = jcc.label_compact_pixels(jp, width=w)
        got = tcc.label_compact_pixels(tpx, width=w)
    else:
        pcw = tp.pack_pcw(torch.from_numpy(strong), tp.nwl_for_width(w))
        jp, jnbu, jnbd = jcomp.compact_from_pcw(
            jnp.asarray(image), jnp.asarray(pcw.numpy()), max_pixels=K, with_neighbors=True
        )
        tpx, tnbu, tnbd = tcomp.compact_from_pcw(
            torch.from_numpy(image), pcw, max_pixels=K, with_neighbors=True
        )
        want = jcc.label_compact_pixels(jp, width=w, neighbors=(jnbu, jnbd))
        got = tcc.label_compact_pixels(tpx, width=w, neighbors=(tnbu, tnbd))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = int(jp.count)
    assert len(np.unique(np.asarray(want)[:n])) >= 4


def _assert_tables_equal(got, want, f64: bool):
    for name in jcc.SpotTable._fields:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if f64 and name in ("com_x", "com_y"):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("jdt,tdt", [(jnp.float64, torch.float64), (jnp.float32, torch.float32)])
def test_spot_table_and_filters(frame, jdt, tdt):
    strong, image = frame
    w = strong.shape[1]
    jp, tpx = _both_compact(strong, image)
    jroot = jcc.label_compact_pixels(jp, width=w)
    troot = tcc.label_compact_pixels(tpx, width=w)
    want = jcc.spot_table_from_pixels(jp, jroot, width=w, max_spots=MAX_SPOTS, dtype=jdt)
    got = tcc.spot_table_from_pixels(tpx, troot, width=w, max_spots=MAX_SPOTS, dtype=tdt)
    assert got.com_x.dtype == tdt
    _assert_tables_equal(got, want, jdt == jnp.float64)
    assert int(want.n_spots) >= 4

    # the suite runs JAX with x64 on, where the separation test is float64
    for size, sep in ((1, -1.0), (2, 2.0), (3, 0.5), (-1, 1.0)):
        wk, wn_size, wn_sep = jcc.filter_spots(want, size, sep)
        gk, gn_size, gn_sep = tcc.filter_spots(got, size, sep, dtype=torch.float64)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        assert (int(gn_size), int(gn_sep)) == (int(wn_size), int(wn_sep))
