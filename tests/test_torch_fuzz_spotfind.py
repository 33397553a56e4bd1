"""ffs_tpu_torch.tools.fuzz_spotfind against the repo's tools/fuzz_spotfind.py.

On the CPU the port's kernel path runs the kernels' plain versions.  For
the JAX guard's seeds (tests/test_fuzz_smoke.py: 0, 4, 8) the port draws
the JAX tool's frames and mask bit for bit and its seed passes; on one seed
an algorithm the port's kernel-path results equal the JAX tool's dense
processor's under the tool's own comparison (the JAX suite holds its
interpret-mode kernels equal to that dense path).  The edge pool reaches
the walkers' tiling edges at any card's occupancy, and one edge seed an
algorithm passes.  The comparison catches a flipped pixel.
"""

import copy
import pathlib

import numpy as np
import pytest
import torch

from ffs_tpu_torch.ops.dispersion_packed import walker_tiling
from ffs_tpu_torch.tools import fuzz_spotfind as tf

CPU = torch.device("cpu")
JAX_SEEDS = [0, 4, 8]


@pytest.fixture
def jfuzz(monkeypatch):
    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
    import fuzz_spotfind

    return fuzz_spotfind


def _jax_draw(jfuzz, seed):
    """The JAX tool's run_seed draws, in its order."""
    rng = np.random.default_rng(seed)
    h, w, dtype, _, _, _, mask_kind, full_range = jfuzz.CONFIGS[seed % len(jfuzz.CONFIGS)]
    mask = jfuzz._config_mask(mask_kind, h, w)
    info = np.iinfo(dtype)
    trusted_max = float(info.max) if full_range else float(info.max // 2)
    nimg = int(rng.integers(2, 5))
    stack = np.stack([jfuzz._random_frame(rng, h, w, dtype, trusted_max) for _ in range(nimg)])
    return mask, trusted_max, stack


def test_pool_is_the_jax_pool(jfuzz):
    assert tf.CONFIGS == jfuzz.CONFIGS


@pytest.mark.parametrize("seed", JAX_SEEDS)
def test_frames_match_jax(seed, jfuzz):
    _, mask, trusted_max, stack = tf.draw(seed)
    j_mask, j_tm, j_stack = _jax_draw(jfuzz, seed)
    assert trusted_max == j_tm
    np.testing.assert_array_equal(mask, j_mask)
    assert stack.dtype == j_stack.dtype
    np.testing.assert_array_equal(stack, j_stack)


@pytest.mark.parametrize("seed", JAX_SEEDS)
def test_seed_passes_on_cpu(seed):
    assert tf.run_seed(seed, CPU)


@pytest.mark.parametrize("seed", [0, 4])  # dispersion, dispersion_extended
def test_kernel_path_matches_jax_dense(seed, jfuzz):
    (h, w, dtype, algorithm, cc_backend, mss, _, _), mask, tm, stack = tf.draw(seed)
    port = tf.Fuzzer(CPU).processor(h, w, mask, tm, algorithm, cc_backend, True, mss)
    dense = jfuzz._processor(h, w, mask, tm, algorithm, cc_backend, False, mss)
    n_strong = 0
    for n, frame in enumerate(stack):
        got = port.process_frame(n, frame, want_com=True)
        want = dense.process_frame(n, frame, want_com=True)
        assert tf._compare(seed, f"frame {n} port kernel path vs JAX dense", got, want)
        n_strong += got.n_strong_pixels
    assert n_strong > 0


@pytest.mark.parametrize("seed", [0, 3])  # dispersion, dispersion_extended
def test_edge_seed_passes_on_cpu(seed):
    assert tf.EDGE_CONFIGS[seed][3] == ("dispersion" if seed == 0 else "dispersion_extended")
    assert tf.run_seed(seed, CPU, edges=True)


@pytest.mark.parametrize("slots", [132, 264, 528, 1056, 2112])
def test_edge_pool_reaches_the_tiling_edges(slots):
    """At any card's walker occupancy: unequal strips whose last word holds
    one column, widths off the 32 grid, a short last segment, one-segment
    frames; both algorithms and both dtypes."""
    seen = set()
    for h, w, dtype, algorithm, *_ in tf.EDGE_CONFIGS:
        halo = 3 if algorithm == "dispersion" else 10
        for b in (1, 2, 4):
            t = walker_tiling(b, h, w, halo, slots, tf.MAX_STRIP_WORDS)
            words = -(-w // 32)
            if t.strips > 1 and words - (t.strips - 1) * t.wps < t.wps and w % 32 == 1:
                seen.add("unequal strips, one-column last word")
            if w % 32:
                seen.add("width off the 32 grid")
            if t.segs > 1 and h % t.seg_rows:
                seen.add("short last segment")
            if t.segs == 1:
                seen.add(f"one segment {algorithm}")
        seen.add((algorithm, np.dtype(dtype).name))
        assert (h * w) % 8 == 0  # the planes form runs on every edge frame
    assert seen >= {
        "unequal strips, one-column last word", "width off the 32 grid", "short last segment",
        "one segment dispersion", "one segment dispersion_extended",
        ("dispersion", "uint16"), ("dispersion", "uint32"),
        ("dispersion_extended", "uint16"), ("dispersion_extended", "uint32"),
    }


def test_compare_catches_a_flipped_pixel():
    (h, w, _, algorithm, cc_backend, mss, _, _), mask, tm, stack = tf.draw(0)
    proc = tf.Fuzzer(CPU).processor(h, w, mask, tm, algorithm, cc_backend, True, mss)
    res = proc.process_frame(0, stack[0], want_com=True)
    assert res.n_strong_pixels > 1
    assert tf._compare(0, "same", res, copy.deepcopy(res))
    moved = copy.deepcopy(res)
    moved.pixels.linear_index[0] += 1
    assert not tf._compare(0, "moved pixel", moved, res)
    brighter = copy.deepcopy(res)
    brighter.pixels.intensity[-1] += 1
    assert not tf._compare(0, "brighter pixel", brighter, res)
    shifted = copy.deepcopy(res)
    shifted.centers_of_mass[0, 0] += 1e-3
    assert not tf._compare(0, "shifted centroid", shifted, res)
    fewer = copy.deepcopy(res)
    fewer.n_spots -= 1
    assert not tf._compare(0, "count", fewer, res)
