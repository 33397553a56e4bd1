"""The dispersion walkers' tiling (ops.dispersion_packed.walker_tiling), on
the CPU: every output row and word of every frame is written by exactly one
block, and the grid fits the kernels' limits, at the Eiger 16M, Jungfrau 1M
and edge shapes."""

import numpy as np
import pytest

from ffs_tpu_torch.ops import dispersion_packed as tp

# the widest strip the library takes (csrc/common.cuh kMaxStripWords, read
# on the card through ffs_walker_max_strip_words)
MAX_WORDS = 30

SHAPES = [
    (1, 4362, 4148),  # Eiger 16M, per frame
    (8, 4362, 4148),  # the stage tool's and the batched CLI's B = 8
    (112, 1066, 1030),  # Jungfrau 1M, the JAX bench's batch
    (1, 37, 70),
    (1, 9, 70),  # below the extended kernel's 10-row halo
    (1, 1, 1),
    (3, 130, 333),
    (2, 515, 1030),
    (1, 700, 2100),
]


@pytest.mark.parametrize("slots", [1, 132, 264, 528])
@pytest.mark.parametrize("halo", [3, 10])
@pytest.mark.parametrize("shape", SHAPES)
def test_every_row_and_word_written_once(shape, halo, slots):
    b, h, w = shape
    t = tp.walker_tiling(b, h, w, halo, slots, MAX_WORDS)
    words = -(-w // 32)
    assert 1 <= t.wps <= MAX_WORDS
    # the C side's grid from (wps, seg_rows): csrc/common.cuh walker_grid
    assert t.strips == -(-words // t.wps) and t.segs == -(-h // t.seg_rows)
    assert t.segs == 1 or t.seg_rows >= 2 * halo
    count = np.zeros((b, h, words), np.int32)
    for f in range(b):
        for g in range(t.segs):
            for s in range(t.strips):
                count[f, g * t.seg_rows : min((g + 1) * t.seg_rows, h),
                      s * t.wps : min((s + 1) * t.wps, words)] += 1
    assert count.min() == 1 and count.max() == 1
    # every strip holds words, every segment rows: no empty block
    assert (t.strips - 1) * t.wps < words and (t.segs - 1) * t.seg_rows < h


def test_tiling_fills_the_card_at_eiger_16m():
    """One Eiger 16M frame on 264 slots: one wave, no block left over."""
    t = tp.walker_tiling(1, 4362, 4148, 3, 264, MAX_WORDS)
    assert t.strips * t.segs <= 264
    assert t.strips * t.segs > 264 // 2
