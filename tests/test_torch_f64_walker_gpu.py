"""The float64 walker (``csrc/f64_threshold.cu``) against its plain version
on the card, and the spotfinder's float64 step through it.

Marked ``gpu``: every test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture).  On a GPU machine:

    python -m pytest tests/test_torch_f64_walker_gpu.py -m gpu --noconftest -q

Cases: full Eiger 16M u16 frames of the benchmark's traffic
(``ffsbench/frames.py``), one launch a call, single frames and a batch; the
walker tiling's edge shapes with spots on the strip joins and the last
column; fuzzed frames (the spotfinder fuzzer's content: plateaus,
checkerboards, saturated pixels at and above the trusted maximum, three
mask kinds); and sample images 2 and 5 through the float64 processor
against ``tests/data/bench_anchor_golden.npz`` (image 2: 9506 px, 9506
spots).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from ffs_tpu_torch.bench import check_anchor, load_anchor_golden
from ffs_tpu_torch.io import sample_data
from ffs_tpu_torch.ops import dispersion_packed as tp
from ffs_tpu_torch.spotfind import SpotfindConfig, SpotfindProcessor
from ffs_tpu_torch.tools import fuzz_spotfind as fz
from ffs_tpu_torch.utils import tracing

pytestmark = pytest.mark.gpu

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1] / "ffsbench"
TM = 65530.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _launch(img, msk, tm):
    """The walker's rows, checking that the call launched once."""
    before = tp.dispersion_packed_f64.launches
    got = tp.dispersion_packed_f64(img, msk, tm)
    torch.cuda.synchronize()
    assert tp.dispersion_packed_f64.launches == before + 1
    return got


def test_eiger16m_frames_match_plain(cuda):
    from ffsbench import frames as bench_frames

    cfg = json.loads((BENCH_DIR / "configs" / "eiger16m-rotation-f64.json").read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / "rotation300.catchup.json").read_text())
    traffic["distinct_frames"] = 2
    stack = bench_frames.make_frames(cfg, traffic, 2**31 + 77, cuda)
    msk = torch.from_numpy(bench_frames.detector_mask(cfg["detector"])).to(cuda)
    want = tp.dispersion_packed_f64_plain(stack, msk, TM)
    nwl = want.shape[-1] // 2
    assert (want[:, :, nwl - 1].sum(dim=1) > 1000).all()
    assert torch.equal(_launch(stack, msk, TM), want)
    for b in range(2):
        assert torch.equal(_launch(stack[b], msk, TM), want[b])


@pytest.mark.parametrize("shape", [(40, 961), (10, 300), (97, 200), (104, 1921), (112, 161),
                                   (515, 1030)])
def test_edge_shapes_match_plain(cuda, shape):
    h, w = shape
    rng = np.random.default_rng(h * 7 + w)
    image = fz._edge_frame(rng, h, w, np.uint16, TM)
    image[:, 31::32] += np.uint16(700)  # bit 31 of every word
    mask = fz._config_mask(h % 3, h, w)
    img, msk = torch.from_numpy(image).to(cuda), torch.from_numpy(mask).to(cuda)
    want = tp.dispersion_packed_f64_plain(img, msk, TM)
    assert torch.equal(want.cpu(), tp.dispersion_packed_f64(img.cpu(), msk.cpu(), TM))
    assert torch.equal(_launch(img, msk, TM), want)
    assert int(want[:, want.shape[-1] // 2 - 1].sum()) > 0


@pytest.mark.parametrize("seed", range(12))
def test_fuzzed_frames_match_plain(cuda, seed):
    rng = np.random.default_rng(seed)
    h, w = [(96, 128), (128, 256), (72, 384), (257, 1030)][seed % 4]
    tm = float(rng.choice([TM, 65535.0, 1000.0]))
    batch = np.stack([fz._random_frame(rng, h, w, np.uint16, tm) for _ in range(3)])
    batch[1] = np.clip(batch[1].astype(np.int64) * 60, 0, 65535)  # large window sums
    mask = fz._config_mask(seed % 3, h, w)
    img, msk = torch.from_numpy(batch).to(cuda), torch.from_numpy(mask).to(cuda)
    assert torch.equal(_launch(img, msk, tm), tp.dispersion_packed_f64_plain(img, msk, tm))


def test_float64_step_holds_the_anchors(cuda):
    """The CLI's default step on sample images 2 and 5: one walker launch a
    frame, the counter, and every column of the golden."""
    golden = load_anchor_golden()
    mask = sample_data.generate_mask()
    h, w = mask.shape
    proc = SpotfindProcessor(w, h, mask, 65535.0, SpotfindConfig(min_spot_size=1), device=cuda)
    assert proc._f64_walker and not proc.use_kernel and not proc.host_cc
    rec = tracing.start(False)
    try:
        for tag, idx in (("img2", 2), ("img5", 5)):
            before = tp.dispersion_packed_f64.launches
            pixels, _, table, _, n_boxes, _ = proc.dispatch(sample_data.generate_sample_image(idx))
            torch.cuda.synchronize()
            assert tp.dispersion_packed_f64.launches == before + 1
            n = int(pixels.count)
            errs = check_anchor(golden, tag, w, pixels.linear_index[:n], pixels.intensity[:n],
                                table)
            assert errs == [], errs
            if tag == "img2":
                assert n == 9506 and int(n_boxes) == 9506
        res = proc.process_frame(2, sample_data.generate_sample_image(2))
        assert (res.n_strong_pixels, res.n_spots) == (9506, 9506)
        assert rec.counts["f64_walker_frames"] == 3
    finally:
        tracing.start(False)
