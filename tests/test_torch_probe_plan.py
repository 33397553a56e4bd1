"""The gather probe's ring planner (ffs_tpu_torch.ops.window_gather.probe_plan)
and the checks its wrapper makes before anything runs, on the CPU.

The probe's kernel loads windows through TMA into a ring of ``slots``
shared-memory stages; the planner decides what a stage holds (a whole
window or one window-plane), the shared memory a block opts in to and the
bytes in flight, and refuses a ring that does not fit.  ``slots`` and ``r``
never change a result: on the CPU every pair gives the plain gather's.
"""

import numpy as np
import pytest
import torch

from ffs_tpu_torch.ops import window_gather as wg
from ffs_tpu_torch.tools import measure_window_gather as mwg

LIMIT = wg.H100_SMEM_BLOCK_OPTIN


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("slots,stage_planes", [(2, (4, 1)), (4, (4, 4)), (8, (1, 1)),
                                                (16, (1, 1))])
def test_plan_at_the_tools_shapes(single, slots, stage_planes):
    """bh = 24, P = 4: a window-plane is 24 rows of the form's box width,
    a window four of them.  slots = 8 and 16 fit only window-plane stages;
    slots = 4 keeps as much in flight either way and takes window stages;
    at slots = 2 the double form ties (window stages) and the single
    form's window-plane stages keep nine blocks an SM, more in flight."""
    width = 128 if single else 132
    stage_planes = stage_planes[single]
    plan = wg.probe_plan(4, 24, 8, slots, single_only=single)
    assert plan.stage_planes == stage_planes
    assert plan.stage_bytes == stage_planes * 24 * width * 4
    assert plan.smem_bytes == slots * (plan.stage_bytes + 16) + 128 <= LIMIT
    assert plan.blocks_per_sm == min(
        wg.H100_SMEM_SM // (plan.smem_bytes + wg.SMEM_RESERVED_BLOCK), 2048 // 160)
    assert plan.bytes_in_flight == plan.blocks_per_sm * (slots - 1) * plan.stage_bytes


def test_plan_picks_the_stage_that_keeps_more_in_flight():
    # the integrator's frame block at the defaults: one 67,584 B window
    # stage pair leaves one block an SM, window-plane stages six
    plan = wg.probe_plan(4, 32, 8, 2)
    assert (plan.stage_planes, plan.stage_bytes, plan.blocks_per_sm) == (1, 32 * 528, 6)
    assert plan.bytes_in_flight == 6 * 32 * 528
    # a tie (the tool's slots = 2, double form) keeps the whole window
    window = wg.probe_plan(4, 24, 8, 2)
    assert window.stage_planes == 4 and window.bytes_in_flight == 2 * 50_688
    # one plane: both kinds are the same stage
    assert wg.probe_plan(1, 8, 1, 16).stage_planes == 1
    # r = 1: a block loads one window, so a deep ring of window stages would
    # keep one load; window-plane stages keep four blocks with three ahead
    one = wg.probe_plan(4, 24, 1, 4)
    assert (one.stage_planes, one.blocks_per_sm, one.bytes_in_flight) == (1, 4, 4 * 3 * 12_672)
    # and a ring deeper than a block's stages keeps only those
    assert wg.probe_plan(4, 24, 1, 16).bytes_in_flight == 1 * 4 * 12_672


def test_deeper_rings_keep_more_in_flight():
    flights = [wg.probe_plan(4, 24, 8, s).bytes_in_flight for s in (2, 4, 8, 16)]
    assert flights == sorted(flights) and len(set(flights)) == 4


@pytest.mark.parametrize("single", [False, True])
def test_every_tool_pair_fits(single):
    pairs = set(mwg.SLOTS_R) | {(2, 4), (2, 8), (2, 16)}
    for slots, r in pairs:
        plan = wg.probe_plan(mwg.F, mwg.BH, r, slots, single_only=single)
        assert plan.smem_bytes <= LIMIT and plan.bytes_in_flight > 0


@pytest.mark.parametrize("planes,bh,slots,limit", [
    (4, 256, 2, LIMIT),  # a 256-row window-plane is 135 KB: two never fit
    (1, 24, 32, LIMIT),
    (6, 40, 16, LIMIT),
    (4, 24, 4, 48 * 1024),  # without the opt-in
])
def test_unfit_plan_raises_with_the_limit(planes, bh, slots, limit):
    with pytest.raises(ValueError, match=f"over the {limit} B limit"):
        wg.probe_plan(planes, bh, 8, slots, limit)


def test_box_and_knob_limits_raise():
    with pytest.raises(ValueError, match="largest dimension of a TMA box"):
        wg.probe_plan(1, 264, 8, 2)
    with pytest.raises(ValueError, match="largest dimension of a TMA box"):
        wg.probe_plan(257, 8, 8, 2)
    with pytest.raises(ValueError, match="slots=1"):
        wg.probe_plan(4, 24, 8, 1)
    with pytest.raises(ValueError, match="r=0"):
        wg.probe_plan(4, 24, 0, 2)


def test_wrapper_raises_before_running():
    """bh over 256, an unfit ring and an image that does not start 16-byte
    aligned raise in the wrapper (the plain version shares the checks) and
    count no launch."""
    before = wg.window_gather_probe.launches
    zeros = np.zeros(2, int)
    with pytest.raises(ValueError, match="TMA box"):
        wg.window_gather_probe(torch.zeros((1, 272, 256), dtype=torch.int32), zeros, zeros,
                               bh=264)
    with pytest.raises(ValueError, match="limit"):
        wg.window_gather_probe(torch.zeros((2, 32, 256), dtype=torch.int32), zeros, zeros,
                               bh=24, slots=32)
    flat = torch.zeros(2 * 32 * 256 + 1, dtype=torch.int32)
    misaligned = flat[1:].view(2, 32, 256)
    assert misaligned.data_ptr() % 16 == 4
    for fn in (wg.window_gather_probe, wg.window_gather_probe_plain):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(misaligned, zeros, zeros, bh=8)
    # a copy starts aligned
    assert wg.window_gather_probe(misaligned.clone(), zeros, zeros, bh=8).shape == (2, 2, 8, 128)
    assert wg.window_gather_probe.launches == before


@pytest.mark.parametrize("single", [False, True])
def test_outputs_equal_across_slots_and_r(single):
    rng = np.random.default_rng(21)
    p, hp, wp, bh = 3, 40, 384, 16
    img = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (p, hp, wp), dtype=np.int64)
                           .astype(np.int32))
    a = 13
    y0 = rng.integers(0, hp - bh + 1, a)
    x0 = rng.integers(0, wp - 128, a)
    x0[:3] = [wp - 129, 5, 128]
    ref = wg.window_gather_probe(img, y0, x0, bh=bh, single_only=single)
    cols = wg.probe_columns(x0, wp, single)
    want = np.stack([img.numpy()[:, y0[k]:y0[k] + bh][:, :, cols[k]] for k in range(a)])
    np.testing.assert_array_equal(ref.numpy(), want)
    for r in (1, 3, 8, 16):
        for slots in (2, 4, 8, 16):
            got = wg.window_gather_probe(img, y0, x0, bh=bh, single_only=single, r=r,
                                         slots=slots)
            assert torch.equal(got, ref), (r, slots)
