"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, never at import).  On a GPU machine run

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q

which builds the kernels with nvcc on first use.
"""

import numpy as np
import pytest
import torch

from ffs_tpu_torch.ops import dispersion_extended_packed as txp
from ffs_tpu_torch.ops import dispersion_packed as tp

pytestmark = pytest.mark.gpu

KERNELS = {
    "dispersion": (tp.dispersion_packed_raw, tp.dispersion_packed_plain, tp.mask_box_count),
    "dispersion_extended": (
        txp.dispersion_extended_packed_raw,
        txp.dispersion_extended_packed_plain,
        txp.mask_box_count_extended,
    ),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _frame(h, w, dtype, seed):
    rng = np.random.default_rng(seed)
    image = rng.poisson(6.0, size=(h, w)).astype(dtype)
    for y, x in zip(rng.integers(4, h - 4, 40), rng.integers(4, w - 4, 40)):
        image[y - 1 : y + 2, x - 2 : x + 2] += dtype(900)
    mask = np.ones((h, w), np.uint8)
    mask[h // 3 : h // 3 + 5] = 0
    mask[:, w // 2 : w // 2 + 3] = 0
    if dtype == np.uint32:
        image[5, 7] = image[h - 3, w - 9] = 0xFFFFFFFF
    if dtype == np.int32:  # CBF-like: -1 under the mask, one unmasked -2
        image[mask == 0] = -1
        image[h - 5, 3] = -2
    return image, mask


@pytest.mark.parametrize("shape", [(37, 70), (130, 333), (515, 1030)])
@pytest.mark.parametrize("pixels", [np.uint16, np.uint32, np.int32])
@pytest.mark.parametrize("algorithm", list(KERNELS))
def test_kernel_matches_plain(cuda, algorithm, pixels, shape):
    raw, plain, mbox_fn = KERNELS[algorithm]
    image, mask = _frame(*shape, pixels, seed=shape[0])
    img, msk = torch.from_numpy(image).to(cuda), torch.from_numpy(mask).to(cuda)
    want = plain(img, msk, 65535.0)
    assert torch.equal(want.cpu(), raw(img.cpu(), msk.cpu(), 65535.0))
    for mbox in (None, mbox_fn(msk)):
        before = raw.launches
        got = raw(img, msk, 65535.0, mbox=mbox)
        torch.cuda.synchronize()
        assert raw.launches == before + 1
        assert torch.equal(got, want)
    nwl = want.shape[-1] // 2
    assert int(want[:, nwl - 1].sum()) > 0


@pytest.mark.parametrize("shape", [(37, 70), (130, 333), (515, 1030)])
@pytest.mark.parametrize("pixels", [np.uint16, np.uint32, np.int32])
def test_fused_kernels_match_plain(cuda, pixels, shape):
    """The rowcum entries against their plain versions, bit for bit, with
    and without the strong plane (and, for dispersion, the mask box count
    and the signal test)."""
    image, mask = _frame(*shape, pixels, seed=shape[1])
    image[:, 31::32] += pixels(700)  # strong pixels in bit 31 of a word
    img, msk = torch.from_numpy(image).to(cuda), torch.from_numpy(mask).to(cuda)
    mbox = tp.mask_box_count(msk)
    cases = [(txp.dispersion_extended_fused, txp.dispersion_extended_fused_plain, {})]
    for signal_test in (True, False):
        cases += [(tp.dispersion_fused, tp.dispersion_fused_plain, dict(signal_test=signal_test))]
    for fused, plain, kw in cases:
        want_strong, want_rowcum = plain(img, msk, 65535.0, **kw)
        assert torch.equal(torch.cumsum(want_strong, -1, dtype=torch.int32), want_rowcum)
        assert int(want_rowcum[:, -1].sum()) > 0
        extra = [{}] if fused is txp.dispersion_extended_fused else [{}, {"mbox": mbox}]
        for more in extra:
            for emit_strong in (True, False):
                before = fused.launches
                strong, rowcum = fused(img, msk, 65535.0, emit_strong=emit_strong, **kw, **more)
                torch.cuda.synchronize()
                assert fused.launches == before + 1
                assert torch.equal(rowcum, want_rowcum)
                assert (strong is None) if not emit_strong else torch.equal(strong, want_strong)


def test_batched_frames(cuda):
    image, mask = _frame(96, 200, np.uint16, seed=1)
    batch = torch.from_numpy(np.stack([image, np.roll(image, 5, axis=0)])).to(cuda)
    msk = torch.from_numpy(mask).to(cuda)
    for raw, plain, _ in KERNELS.values():
        assert torch.equal(raw(batch, msk, 65535.0), plain(batch, msk, 65535.0))
    for fused, plain in ((tp.dispersion_fused, tp.dispersion_fused_plain),
                         (txp.dispersion_extended_fused, txp.dispersion_extended_fused_plain)):
        for got, want in zip(fused(batch, msk, 65535.0), plain(batch, msk, 65535.0)):
            assert got.shape == batch.shape and torch.equal(got, want)


def test_kernel_rejects_bad_inputs(cuda):
    image, mask = _frame(40, 64, np.uint16, seed=2)
    img = torch.from_numpy(image).to(cuda)
    with pytest.raises(ValueError, match="mask is on"):
        tp.dispersion_packed_raw(img, torch.from_numpy(mask), 65535.0)
    with pytest.raises(TypeError):
        tp.dispersion_packed_raw(img.to(torch.float32), torch.from_numpy(mask).to(cuda), 65535.0)


@pytest.mark.parametrize(
    "cfg",
    [
        dict(precision="f32"),
        dict(precision="f32", algorithm="dispersion_extended"),
        dict(precision="f32", cc_backend="device"),
        dict(precision="f64"),
        dict(precision="f64", cc_backend="host", algorithm="dispersion_extended"),
    ],
)
def test_processor_on_gpu_matches_cpu(cuda, cfg):
    """Every processor path on the card against the same path on the CPU
    (the CPU side runs the kernels' plain versions)."""
    from ffs_tpu_torch.spotfind import SpotfindConfig, SpotfindProcessor

    image, mask = _frame(300, 420, np.uint16, seed=3)
    gpu_cfg = SpotfindConfig(min_spot_size=1, **cfg)
    gpu = SpotfindProcessor(420, 300, mask, 65535.0, gpu_cfg, device=cuda)
    cpu_cfg = SpotfindConfig(min_spot_size=1, use_kernel=gpu.use_kernel, **cfg)
    cpu = SpotfindProcessor(420, 300, mask, 65535.0, cpu_cfg, device=torch.device("cpu"))
    assert gpu.use_kernel == (cfg["precision"] == "f32")
    for num, frame in enumerate([image, np.roll(image, 17, axis=1)]):
        a, b = gpu.process_frame(num, frame), cpu.process_frame(num, frame)
        assert (a.n_strong_pixels, a.n_spots, a.n_spots_prefilter, a.n_strong_pixels_filtered) == (
            b.n_strong_pixels, b.n_spots, b.n_spots_prefilter, b.n_strong_pixels_filtered
        )
        for name in ("linear_index", "intensity", "root"):
            np.testing.assert_array_equal(getattr(a.pixels, name), getattr(b.pixels, name))
        assert a.n_strong_pixels > 0


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("planes", [1, 4, 6])
def test_window_gathers_match_plain(cuda, dtype, planes):
    """Both gather kernels against their plain versions, bit for bit (the
    float32 case compares the raw bits), with windows at the contract's
    edges: the last legal column start Wp-129 and the bottom-most row."""
    from ffs_tpu_torch.ops import window_gather as wg

    rng = np.random.default_rng(planes)
    hp, wp, bh, a = 70, 384, 24, 300
    img = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (planes, hp, wp), dtype=np.int64)
                           .astype(np.int32)).to(cuda)
    img = img.view(dtype)  # float32: arbitrary bit patterns, NaNs included
    y0 = rng.integers(0, hp - bh + 1, a)
    x0 = rng.integers(0, wp - 128, a)
    y0[:2], x0[:2] = [hp - bh, 0], [wp - 129, wp - 129]
    if planes == 1:
        fn, plain, src = wg.window_gather, wg.window_gather_plain, img[0]
    else:
        fn, plain, src = wg.window_gather_planes, wg.window_gather_planes_plain, img
    want = plain(src, y0, x0, bh=bh)
    assert torch.equal(want.cpu().view(torch.int32), fn(src.cpu(), y0, x0, bh=bh).view(torch.int32))
    before = fn.launches
    got = fn(src, y0, x0, bh=bh)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError, match="x0"):
        fn(src, y0, np.full(a, wp - 128), bh=bh)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_gather_variants_match_plain(cuda, dtype):
    """The packed, plane-last and probe gathers against their plain
    versions, bit for bit, with windows at the contract's edges."""
    from ffs_tpu_torch.ops import window_gather as wg

    rng = np.random.default_rng(9)
    planes, hp, wp, bh, a = 4, 70, 512, 24, 300
    img = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (planes, hp, wp), dtype=np.int64)
                           .astype(np.int32)).to(cuda).view(dtype)
    pl = img.reshape(planes, hp, wp // 128, 128).permute(1, 2, 0, 3).contiguous()
    y0 = rng.integers(0, hp - bh + 1, a)
    x0 = rng.integers(0, wp - 128, a)
    y0[:3], x0[:3] = [hp - bh, 0, 5], [wp - 129, wp - 129, 256]
    cases = [
        (wg.window_gather_planes_packed, wg.window_gather_planes_packed_plain, img, {}),
        (wg.window_gather_planes_pl, wg.window_gather_planes_pl_plain, pl, {}),
    ] + [
        (wg.window_gather_probe, wg.window_gather_probe_plain, img,
         dict(single_only=single, r=r, slots=slots))
        for single in (False, True) for r in (1, 3, 8, 16) for slots in (2, 4, 16)
    ]
    pf = wg.window_gather_planes_plain(img, y0, x0, bh=bh)
    for fn, plain, src, kw in cases:
        want = plain(src, y0, x0, bh=bh, **kw)
        before = fn.launches
        got = fn(src, y0, x0, bh=bh, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (fn.__name__, kw)
        if fn is not wg.window_gather_planes_packed and not kw.get("single_only"):
            assert torch.equal(got.view(torch.int32), pf.view(torch.int32))


@pytest.mark.parametrize("bh", [8, 24, 40, 256])
@pytest.mark.parametrize("planes", [1, 4, 6])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_probe_ring_matches_plain(cuda, dtype, planes, bh):
    """The probe's TMA ring against its plain version, bit for bit, in both
    forms over r, slots and window counts (none, fewer than a block's r,
    a partial last block), at the contract's edges and x0 % 4 != 0, with
    float32 NaN bit patterns; a plan the shared memory cannot hold raises
    before a launch, in the kernel's wrapper and the plain version alike."""
    from ffs_tpu_torch.ops import window_gather as wg

    rng = np.random.default_rng(100 + planes + bh)
    hp, wp = bh + 61, 640
    bits = rng.integers(-(2**31), 2**31 - 1, (planes, hp, wp), dtype=np.int64).astype(np.int32)
    bits[:, :, 7::61] = np.array([0x7FC00001, -1, 0x7F800001, -4194304], np.int32)[
        np.arange(bits[:, :, 7::61].shape[-1]) % 4]  # quiet, negative and signalling NaNs
    img = torch.from_numpy(bits).to(cuda).view(dtype)
    y0 = rng.integers(0, hp - bh + 1, 2049)
    x0 = rng.integers(0, wp - 128, 2049)
    y0[:5] = [hp - bh, 0, 3, hp - bh, 1]
    x0[:5] = [wp - 129, 256, 5, 0, 383]  # the last start, aligned, x0 % 4 == 1, 0, 3
    ran = 0
    for r in (1, 3, 8, 16):
        for slots in (2, 4, 16):
            try:
                plan = wg.probe_plan(planes, bh, r, slots)
            except ValueError as e:
                assert "limit" in str(e)
                with pytest.raises(ValueError, match="limit"):
                    wg.window_gather_probe(img, y0[:r], x0[:r], bh=bh, r=r, slots=slots)
                with pytest.raises(ValueError, match="limit"):
                    wg.window_gather_probe_plain(img, y0[:r], x0[:r], bh=bh, r=r, slots=slots)
                continue
            assert plan.smem_bytes <= torch.cuda.get_device_properties(
                cuda).shared_memory_per_block_optin
            for a in sorted({1, r - 1, 2049}):
                for single in (False, True):
                    kw = dict(single_only=single, r=r, slots=slots)
                    want = wg.window_gather_probe_plain(img, y0[:a], x0[:a], bh=bh, **kw)
                    before = wg.window_gather_probe.launches
                    got = wg.window_gather_probe(img, y0[:a], x0[:a], bh=bh, **kw)
                    torch.cuda.synchronize()
                    assert wg.window_gather_probe.launches == before + 1
                    assert got.dtype == dtype and got.shape == want.shape == (a, planes, bh, 128)
                    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (a, kw)
                    ran += 1
    assert ran > 0 or bh == 256  # a 256-row window-plane is 128 KB: two never fit


def test_probe_unfit_plan_and_misaligned_base_raise(cuda):
    """Plans the card's shared memory cannot hold, boxes over 256 rows and
    an image that does not start 16-byte aligned raise ValueError before a
    launch; the launch counter stays."""
    from ffs_tpu_torch.ops import window_gather as wg

    img = torch.zeros((2, 300, 512), dtype=torch.int32, device=cuda)
    y0, x0 = np.zeros(4, int), np.zeros(4, int)
    before = wg.window_gather_probe.launches
    for bh, slots in ((256, 2), (24, 32), (40, 16)):
        with pytest.raises(ValueError, match="limit"):
            wg.window_gather_probe(img, y0, x0, bh=bh, slots=slots)
    with pytest.raises(ValueError, match="256"):
        wg.window_gather_probe(torch.zeros((1, 300, 512), dtype=torch.int32, device=cuda),
                               y0, x0, bh=264)
    flat = torch.zeros(2 * 64 * 512 + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        wg.window_gather_probe(flat[1:].view(2, 64, 512), y0, x0, bh=8)
    assert wg.window_gather_probe.launches == before


def test_kabsch_integrate_on_gpu_matches_cpu(cuda):
    """The integrator's blocked step on the card (gather kernels) against
    the same step on the CPU (plain gathers): the eight accumulators equal."""
    from ffs_tpu_torch.integration import kabsch as kb
    from ffs_tpu_torch.models.geometry import Goniometer, MonochromaticBeam, Scan, simple_panel

    rng = np.random.default_rng(4)
    w, h, nf, a = 300, 200, 6, 150
    panel = simple_panel(100.0, (w / 2, h / 2), (0.1, 0.1), (w, h))
    beam = MonochromaticBeam(wavelength=0.976)
    scan = Scan(image_range=(1, nf), oscillation=(0.0, 0.2))
    x, y = rng.uniform(12, w - 12, a), rng.uniform(12, h - 12, a)
    lab = panel.get_lab_coord(*panel.px_to_mm(x, y))
    s1 = lab / np.linalg.norm(lab, axis=1, keepdims=True) / beam.wavelength
    z0 = rng.integers(0, nf - 2, a)
    bboxes = np.stack([x - 9, x + 9, y - 9, y + 9, z0, z0 + 3], axis=1).astype(np.int64)
    frames = rng.poisson(5.0, (nf, h, w)).astype(np.uint16)
    mask = np.ones((h, w), np.uint8)
    mask[90:95] = 0

    class Reader:
        def get_image(self, n):
            return frames[n]

        def get_mask(self):
            return mask

    accs = []
    for dev in (cuda, torch.device("cpu")):
        integ = kb.KabschIntegrator(
            panel=panel, beam=beam, gonio=Goniometer(), scan=scan, s1=s1,
            phi=np.deg2rad(0.2 * (z0 + 1.5)), bboxes=bboxes, delta_b=np.deg2rad(0.5),
            delta_m=np.deg2rad(0.3), max_active=64, device=dev,
        )
        acc = kb.Accumulators.zeros(a)
        integ.integrate(Reader(), range(nf), acc)
        accs.append(acc)
    assert accs[0].fg_count.sum() > 0
    for name in ("fg_sum", "fg_count", "sum_ix", "sum_iy", "sum_iz", "bg_hist", "bg_overflow",
                 "bg_count"):
        np.testing.assert_array_equal(getattr(accs[0], name), getattr(accs[1], name), err_msg=name)


@pytest.mark.parametrize("block_elem", [4096, 2048, 200])
@pytest.mark.parametrize("dtype", [torch.uint16, torch.uint32])
def test_bitshuffle_frames_match_plain(cuda, dtype, block_elem):
    """The decode kernel against its plain version, bit for bit: random
    plane bytes (every bit pattern), B = 3, a partial final block, default
    and non-default block sizes."""
    from ffs_tpu_torch.ops import bitshuffle_device as bd

    s = 2 if dtype == torch.uint16 else 4
    h, w = 48, 1030  # 49,440 px: a multiple of 8, not of any block size here
    n_blocks = -(-(h * w) // block_elem)
    rng = np.random.default_rng(block_elem + s)
    planes = torch.from_numpy(
        rng.integers(0, 256, (3, n_blocks, block_elem * s), dtype=np.uint8)).to(cuda)
    want = bd.frames_from_planes_plain(planes, h, w, dtype)
    assert torch.equal(want.cpu().view(torch.uint8), bd.frames_from_planes(planes.cpu(), h, w, dtype)
                       .view(torch.uint8))
    before = bd.frames_from_planes.launches
    got = bd.frames_from_planes(planes, h, w, dtype)
    torch.cuda.synchronize()
    assert bd.frames_from_planes.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    with pytest.raises(ValueError, match="planes hold"):
        bd.frames_from_planes(planes[:, :-1], h, w, dtype)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_bitshuffle_frames_decode_the_codec(cuda, dtype):
    """Frames through the port's codec (LZ4 planes) and the kernel come back
    as they went in."""
    from ffs_tpu_torch.io import compression
    from ffs_tpu_torch.ops import bitshuffle_device as bd

    frames = np.stack([_frame(36, 132, dtype, seed=k)[0] for k in range(2)])
    planes = np.stack([
        compression.bshuf_lz4_planes(compression.bshuf_lz4_compress(f, f.dtype.itemsize),
                                     f.size, f.dtype.itemsize)[0]
        for f in frames
    ])
    tdt = torch.uint16 if dtype == np.uint16 else torch.uint32
    got = bd.frames_from_planes(torch.from_numpy(planes).to(cuda), 36, 132, tdt)
    np.testing.assert_array_equal(got.cpu().numpy(), frames)


@pytest.mark.parametrize("block_elem", [8192, 1024, 200])
@pytest.mark.parametrize("elem_size", [1, 2, 4])
def test_untranspose_planes_match_plain(cuda, elem_size, block_elem):
    """The decode kernel over a chunk's blocks (``untranspose_planes``, the
    entry of ``decode_blocks``) against the plain untranspose, bit for bit,
    at S = 1, 2 and 4: random plane bytes, 5 blocks, one launch."""
    from ffs_tpu_torch.ops import bitshuffle_device as bd

    rng = np.random.default_rng(block_elem + elem_size)
    planes = torch.from_numpy(
        rng.integers(0, 256, (5, block_elem * elem_size), dtype=np.uint8)).to(cuda)
    want = bd.untranspose_planes_plain(planes, elem_size)
    before = bd.frames_from_planes.launches
    got = bd.untranspose_planes(planes, elem_size)
    torch.cuda.synchronize()
    assert bd.frames_from_planes.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    with pytest.raises(ValueError, match="8-element groups"):
        bd.untranspose_planes(planes[:, :-1], elem_size)


@pytest.mark.parametrize("n_elem", [8, 4096, 4096 * 3, 10000, 10007, 1025, 63, 5])
@pytest.mark.parametrize("elem_size", [1, 2, 4])
def test_chunk_decode_on_the_card_matches_host_codec(cuda, elem_size, n_elem):
    """``bshuf_lz4_decompress_device`` on the card against the host codec,
    bit for bit: tests/test_bitshuffle_device.py's cases (a group, a block,
    several, a partial block, raw tails, a tail alone)."""
    from ffs_tpu_torch.io import compression
    from ffs_tpu_torch.ops import bitshuffle_device as bd

    dt = {1: np.uint8, 2: np.uint16, 4: np.uint32}[elem_size]
    data = np.random.default_rng(n_elem + elem_size).integers(
        0, int(np.iinfo(dt).max) + 1, size=n_elem, dtype=dt)
    chunk = compression.bshuf_lz4_compress(data, elem_size)
    before = bd.frames_from_planes.launches
    got = bd.bshuf_lz4_decompress_device(chunk, n_elem, elem_size, device=cuda)
    assert bd.frames_from_planes.launches == before + (1 if n_elem >= 8 else 0)
    np.testing.assert_array_equal(got, compression.bshuf_lz4_decompress(chunk, n_elem, elem_size))
    np.testing.assert_array_equal(got.view(dt), data)


@pytest.mark.parametrize("cc_backend", ["host", "device"])
def test_batch_on_gpu_matches_cpu(cuda, cc_backend):
    """The batched path on the card (decode, dispersion kernels) against
    the same path on the CPU (plain versions): every per-frame result."""
    from ffs_tpu_torch.io import compression
    from ffs_tpu_torch.spotfind import SpotfindConfig, SpotfindProcessor

    image, mask = _frame(300, 420, np.uint16, seed=5)
    stack = np.stack([image, np.roll(image, 17, axis=1), np.zeros_like(image)])
    planes = np.stack([
        compression.bshuf_lz4_planes(compression.bshuf_lz4_compress(f, 2), f.size, 2)[0]
        for f in stack
    ])
    out = []
    for dev in (cuda, torch.device("cpu")):
        cfg = SpotfindConfig(precision="f32", use_kernel=True, cc_backend=cc_backend,
                             min_spot_size=1)
        proc = SpotfindProcessor(420, 300, mask, 65535.0, cfg, device=dev)
        out.append(proc.collect_batch(range(3), proc.dispatch_batch_planes(planes), want_com=True))
        out.append(proc.collect_batch(range(3), proc.dispatch_batch(stack), want_com=True))
    assert out[0][0].n_strong_pixels > 0
    for results in out[1:]:
        for a, b in zip(out[0], results):
            assert (a.n_strong_pixels, a.n_spots, a.n_spots_prefilter,
                    a.n_strong_pixels_filtered) == (b.n_strong_pixels, b.n_spots,
                                                    b.n_spots_prefilter, b.n_strong_pixels_filtered)
            for name in ("linear_index", "intensity", "root"):
                np.testing.assert_array_equal(getattr(a.pixels, name), getattr(b.pixels, name))
            # exact: every float32 sum here is of integers below 2^24, so the
            # card's order of atomic adds cannot move a bit
            np.testing.assert_array_equal(a.centers_of_mass, b.centers_of_mass)


# --- the row walker's edges: every case bit-equal to the plain version, for
# all three pixel types and both algorithms, with and without the mask count


def _walker_tiling(algorithm, frames):
    """The tiling the wrapper launches for these (B, H, W) frames."""
    extended = algorithm == "dispersion_extended"
    return tp.launch_tiling(frames, txp.HALO if extended else 3, extended, True)


def _assert_walker_matches(raw, plain, mbox_fn, img, msk):
    want = plain(img, msk, 65535.0)
    for mbox in (None, mbox_fn(msk)):
        got = raw(img, msk, 65535.0, mbox=mbox)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (tuple(img.shape), mbox is not None)
    return want


@pytest.mark.parametrize("h", [1, 2, 5, 9, 10, 11])
@pytest.mark.parametrize("pixels", [np.uint16, np.uint32, np.int32])
@pytest.mark.parametrize("algorithm", list(KERNELS))
def test_walker_frames_below_the_halo(cuda, algorithm, pixels, h):
    """Frames fewer rows tall than the extended kernel's 10-row halo."""
    raw, plain, mbox_fn = KERNELS[algorithm]
    rng = np.random.default_rng(h)
    image = rng.poisson(6.0, size=(h, 70)).astype(pixels)
    image[:, 10::17] += pixels(900)
    mask = np.ones((h, 70), np.uint8)
    mask[:, 33] = 0
    img, msk = torch.from_numpy(image).to(cuda), torch.from_numpy(mask).to(cuda)
    _assert_walker_matches(raw, plain, mbox_fn, img, msk)


@pytest.mark.parametrize("pixels", [np.uint16, np.uint32, np.int32])
@pytest.mark.parametrize("algorithm", list(KERNELS))
def test_walker_segment_remainders(cuda, algorithm, pixels):
    """Heights one below, at and one above a multiple of the launch's
    segment height: a last segment one row short, a whole one, and one of
    a single row."""
    raw, plain, mbox_fn = KERNELS[algorithm]
    dtype = getattr(torch, np.dtype(pixels).name)
    found = {}
    for h in range(24, 700):
        t = _walker_tiling(algorithm, torch.empty((1, h, 300), dtype=dtype, device=cuda))
        last = h - (t.segs - 1) * t.seg_rows
        kind = {t.seg_rows - 1: "short", t.seg_rows: "whole", 1: "one"}.get(last)
        if t.segs > 1 and kind is not None:
            found.setdefault(kind, h)
        if len(found) == 3:
            break
    assert set(found) == {"short", "whole", "one"}, found
    for h in found.values():
        image, mask = _frame(h, 300, pixels, seed=h)
        img, msk = torch.from_numpy(image).to(cuda), torch.from_numpy(mask).to(cuda)
        _assert_walker_matches(raw, plain, mbox_fn, img, msk)


@pytest.mark.parametrize("w", [1, 3, 31, 33, 40, 129, 333, 961, 1030])
@pytest.mark.parametrize("pixels", [np.uint16, np.uint32, np.int32])
@pytest.mark.parametrize("algorithm", list(KERNELS))
def test_walker_ragged_widths(cuda, algorithm, pixels, w):
    """Widths below one strip, across a strip and not multiples of 4 or 8;
    mask bytes other than 0 and 1 count as valid."""
    raw, plain, mbox_fn = KERNELS[algorithm]
    rng = np.random.default_rng(w)
    image = rng.poisson(6.0, size=(48, w)).astype(pixels)
    image[20:23, ::7] += pixels(900)
    mask = np.where(rng.random((48, w)) < 0.95, rng.integers(1, 256, (48, w)), 0).astype(np.uint8)
    img, msk = torch.from_numpy(image).to(cuda), torch.from_numpy(mask).to(cuda)
    _assert_walker_matches(raw, plain, mbox_fn, img, msk)


def straddling_frame(h, w, dtype, tiling, seed=11):
    """A seeded frame with 5x5 spots centred on every strip boundary column
    and every segment boundary row of ``tiling`` (and their crossings), over
    a Poisson background."""
    rng = np.random.default_rng(seed)
    image = rng.poisson(4.0, size=(h, w)).astype(np.int64)
    cols = [s * tiling.wps * 32 for s in range(1, tiling.strips)] + [w // 2]
    rows = [g * tiling.seg_rows for g in range(1, tiling.segs)] + [h // 2]
    centres = [(y, x) for y in rows for x in range(7, w - 7, 37)]
    centres += [(y, x) for x in cols for y in range(7, h - 7, 41)]
    centres += [(y, x) for y in rows for x in cols]
    for y, x in centres:
        y0, x0 = max(y - 2, 0), max(x - 2, 0)
        image[y0 : y + 3, x0 : x + 3] += rng.poisson(80, size=image[y0 : y + 3, x0 : x + 3].shape)
    return image.astype(dtype)


@pytest.mark.parametrize("pixels", [np.uint16, np.uint32, np.int32])
@pytest.mark.parametrize("algorithm", list(KERNELS))
def test_walker_spots_straddle_boundaries(cuda, algorithm, pixels):
    """5x5 spots across every strip and segment boundary of the launch."""
    raw, plain, mbox_fn = KERNELS[algorithm]
    h, w = 700, 2100
    probe = torch.empty((1, h, w), dtype=getattr(torch, np.dtype(pixels).name), device=cuda)
    t = _walker_tiling(algorithm, probe)
    assert t.strips > 1 and t.segs > 1
    image = straddling_frame(h, w, pixels, t)
    mask = np.ones((h, w), np.uint8)
    mask[h // 3 : h // 3 + 6] = 0
    img, msk = torch.from_numpy(image).to(cuda), torch.from_numpy(mask).to(cuda)
    want = _assert_walker_matches(raw, plain, mbox_fn, img, msk)
    nwl = want.shape[-1] // 2
    assert int(want[:, nwl - 1].sum()) > 100


def jungfrau_batch(b=112, seed=5):
    """(frames, mask): b seeded 1066 x 1030 u16 frames with 60 3x3 spots
    each over a Poisson(2) base and a 42-row module gap band, the JAX
    bench's Jungfrau 1M batch."""
    from ffs_tpu_torch.tools.measure_stages import make_batch

    mask = np.ones((1066, 1030), np.uint8)
    mask[533 : 533 + 42] = 0
    return make_batch(b, mask, spots=60, seed=seed), mask


def test_walker_jungfrau_batch(cuda):
    """B = 112 Jungfrau 1M frames in one launch, both algorithms, with and
    without the mask count, and the rowcum entries."""
    frames, mask = jungfrau_batch()
    img, msk = torch.from_numpy(frames).to(cuda), torch.from_numpy(mask).to(cuda)
    for raw, plain, mbox_fn in KERNELS.values():
        want = _assert_walker_matches(raw, plain, mbox_fn, img, msk)
        assert int(want[..., want.shape[-1] // 2 - 1].sum()) > 0
    for fused, plain in ((tp.dispersion_fused, tp.dispersion_fused_plain),
                         (txp.dispersion_extended_fused, txp.dispersion_extended_fused_plain)):
        for got, want in zip(fused(img, msk, 65535.0), plain(img, msk, 65535.0)):
            assert torch.equal(got, want)
