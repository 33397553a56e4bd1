"""The rowcum (dense prefix-count) thresholds, the measurement path's four
compactions and its stage functions in ffs_tpu_torch against ffs_tpu, bit
for bit.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_dispersion_pallas.py does; the port's wrappers take their plain
PyTorch versions for CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffs_tpu.ops import compact as jcomp
from ffs_tpu.ops import connected_components as jcc
from ffs_tpu.ops.dispersion_extended_pallas import dispersion_extended_fused as j_ext_fused
from ffs_tpu.ops.dispersion_pallas import dispersion_fused as j_fused
from ffs_tpu.ops.dispersion_pallas import dispersion_packed as j_packed
from ffs_tpu.ops.dispersion_pallas import mask_box_count as j_mbox
from ffs_tpu_torch.ops import compact as tcomp
from ffs_tpu_torch.ops import dispersion_extended_packed as txp
from ffs_tpu_torch.ops import dispersion_packed as tp

TM = 65535.0


def _u32_sentinel_frame():
    """The u32 frame of tests/test_dispersion_pallas.py's saturation test:
    0xFFFFFFFF and 2^31 sentinels, unmasked, beside a real spot."""
    rng = np.random.default_rng(4)
    image = rng.integers(0, 100, size=(64, 256)).astype(np.uint32)
    image[10, 50] = 0xFFFFFFFF
    image[50, 200] = 2**31
    image[28:35, 98:105] = 5000
    return image, np.ones((64, 256), np.uint8)


def _bit31_frame(small_frame):
    """small_frame with a bright pixel in bit 31 of several words (columns
    32j+31) and an uneven height."""
    image, mask = small_frame
    image, mask = image[:203].copy(), mask[:203].copy()
    for y, x in ((30, 31), (31, 31), (30, 63), (70, 95), (170, 191), (171, 287)):
        image[y - 1 : y + 2, x - 1 : x + 2] += 900
    image[mask == 0] = 0
    return image, mask


def _frame(small_frame, name):
    if name == "small":
        return small_frame
    if name == "bit31_uneven":
        return _bit31_frame(small_frame)
    return _u32_sentinel_frame()


def _jax_fused(fused, image, mask, **kw):
    strong, rowcum = fused(jnp.asarray(image), jnp.asarray(mask), TM, interpret=True, **kw)
    return (None if strong is None else np.asarray(strong)), np.asarray(rowcum)


def _assert_fused_equal(got, want):
    (gs, gr), (ws, wr) = got, want
    assert gr.dtype == torch.int32
    np.testing.assert_array_equal(gr.numpy(), wr)
    if ws is None:
        assert gs is None
    else:
        assert gs.dtype == torch.uint8
        np.testing.assert_array_equal(gs.numpy(), ws)
        # rowcum is the inclusive row prefix of the strong plane
        np.testing.assert_array_equal(np.cumsum(ws, axis=-1), wr)


@pytest.mark.parametrize(
    "frame,kw",
    [
        ("small", {}),
        ("small", {"signal_test": False}),
        ("small", {"emit_strong": False}),
        ("small", {"mbox": True}),
        ("bit31_uneven", {"mbox": True}),
        ("u32_sentinel", {}),
    ],
)
def test_dispersion_fused_matches_jax(small_frame, frame, kw):
    image, mask = _frame(small_frame, frame)
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("mbox", False):
        jkw["mbox"] = j_mbox(jnp.asarray(mask))
        tkw["mbox"] = tp.mask_box_count(torch.from_numpy(mask))
    want = _jax_fused(j_fused, image, mask, **jkw)
    got = tp.dispersion_fused(torch.from_numpy(image), torch.from_numpy(mask), TM, **tkw)
    _assert_fused_equal(got, want)
    assert want[1][:, -1].sum() > 0
    if frame == "bit31_uneven":
        assert want[0][:, 31::32].any()  # strong pixels in bit 31 of a word
    if frame == "u32_sentinel":
        assert not want[0][10, 50] and not want[0][50, 200]


def test_dispersion_fused_batched(small_frame):
    image, mask = _bit31_frame(small_frame)
    batch = np.stack([image, np.roll(image, 9, axis=1)])
    mbox = tp.mask_box_count(torch.from_numpy(mask))
    want = _jax_fused(j_fused, batch, mask, mbox=j_mbox(jnp.asarray(mask)))
    got = tp.dispersion_fused(torch.from_numpy(batch), torch.from_numpy(mask), TM, mbox=mbox)
    assert got[1].shape == batch.shape
    _assert_fused_equal(got, want)


def test_dispersion_fused_rejects_other_radius(small_frame):
    image, mask = small_frame
    with pytest.raises(ValueError, match="radius"):
        tp.dispersion_fused(torch.from_numpy(image), torch.from_numpy(mask), TM, radius=5)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("emit_strong", [True, False])
def test_dispersion_extended_fused_matches_jax(small_frame, batched, emit_strong):
    image, mask = small_frame
    if batched:
        image = np.stack([image, (image // 2).astype(image.dtype)])
    want = _jax_fused(j_ext_fused, image, mask, emit_strong=emit_strong)
    got = txp.dispersion_extended_fused(
        torch.from_numpy(image), torch.from_numpy(mask), TM, emit_strong=emit_strong
    )
    _assert_fused_equal(got, want)
    assert want[1][..., -1].sum() > 0


def test_dispersion_packed_split_matches_jax(small_frame):
    image, mask = _bit31_frame(small_frame)
    batch = np.stack([image, np.roll(image, 5, axis=0)])
    want = j_packed(jnp.asarray(batch), jnp.asarray(mask), TM, mbox=j_mbox(jnp.asarray(mask)),
                    interpret=True)
    got = tp.dispersion_packed(torch.from_numpy(batch), torch.from_numpy(mask), TM,
                               mbox=tp.mask_box_count(torch.from_numpy(mask)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _assert_pixels_equal(got, want):
    assert int(got.count) == int(want.count)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _flat_batch():
    """The frames of tests/test_connected_components.py's flat-batch test:
    spots touching the frame edges stress the virtual gap row."""
    rng = np.random.default_rng(5)
    b, h, w = 3, 256, 320
    imgs = rng.poisson(2.0, (b, h, w)).astype(np.uint16)
    for k in range(b):
        for _ in range(40):
            y, x = rng.integers(4, h - 4), rng.integers(4, w - 4)
            imgs[k, y - 1 : y + 2, x - 1 : x + 2] += rng.poisson(60, (3, 3)).astype(np.uint16)
    imgs[0, h - 2 : h, 100:103] += 500
    imgs[1, 0:2, 100:103] += 500
    return imgs, np.ones((h, w), np.uint8)


@pytest.mark.parametrize("k", [8192, 40])  # 40: past capacity
def test_flat_compactions_match_jax(k):
    imgs, mask = _flat_batch()
    _, rowcum = tp.dispersion_fused(torch.from_numpy(imgs), torch.from_numpy(mask), TM)
    words, pc = tp.dispersion_packed(torch.from_numpy(imgs), torch.from_numpy(mask), TM)
    jimgs = jnp.asarray(imgs)
    want = jcomp.compact_from_rowcum_flat(jimgs, jnp.asarray(rowcum.numpy()), max_pixels_total=k)
    got = tcomp.compact_from_rowcum_flat(torch.from_numpy(imgs), rowcum, max_pixels_total=k)
    _assert_pixels_equal(got, want)
    wantw = jcomp.compact_from_words_flat(
        jimgs, jnp.asarray(words.numpy()), jnp.asarray(pc.numpy()), max_pixels_total=k
    )
    gotw = tcomp.compact_from_words_flat(torch.from_numpy(imgs), words, pc, max_pixels_total=k)
    _assert_pixels_equal(gotw, wantw)
    _assert_pixels_equal(gotw, got)
    assert int(got.count) > 40
    # tall rows: frame 1 starts after frame 0's h rows and its gap row
    lin = got.linear_index.numpy()
    if k > int(got.count):
        assert (lin[: int(got.count)] // 320 >= 257).sum() > 0


@pytest.mark.parametrize("k", [2048, 16])
@pytest.mark.parametrize("pixels", ["u16", "u32"])
def test_single_frame_compactions_match_jax(small_frame, pixels, k):
    if pixels == "u16":
        image, mask = small_frame
        timg, tmask = torch.from_numpy(image), torch.from_numpy(mask)
        _, rowcum = tp.dispersion_fused(timg, tmask, TM)
        words, pc = tp.dispersion_packed(timg, tmask, TM)
    else:
        # a sparse strong plane over the u32 sentinel frame, sentinels
        # included: their intensities wrap negative in int32
        image, _ = _u32_sentinel_frame()
        strong = np.random.default_rng(9).random(image.shape) < 0.01
        strong[10, 50] = strong[50, 200] = strong[0, 31] = True
        timg = torch.from_numpy(image)
        rowcum = torch.from_numpy(np.cumsum(strong, axis=1).astype(np.int32))
        pcw = tp.pack_pcw(torch.from_numpy(strong), tp.nwl_for_width(image.shape[1]))
        nwl = pcw.shape[1] // 2
        words, pc = pcw[:, nwl:], pcw[:, :nwl]
    want = jcomp.compact_from_rowcum(jnp.asarray(image), jnp.asarray(rowcum.numpy()), max_pixels=k)
    got = tcomp.compact_from_rowcum(timg, rowcum, max_pixels=k)
    _assert_pixels_equal(got, want)
    wantw = jcomp.compact_from_words(
        jnp.asarray(image), jnp.asarray(words.numpy()), jnp.asarray(pc.numpy()), max_pixels=k
    )
    gotw = tcomp.compact_from_words(timg, words, pc, max_pixels=k)
    _assert_pixels_equal(gotw, wantw)
    _assert_pixels_equal(gotw, got)
    assert int(got.count) > 16
    if pixels == "u32" and k > int(got.count):
        assert (got.intensity.numpy() < 0).sum() == 2


def test_flat_compaction_guards_the_sort_keys():
    # 30 Eiger 16M frames: one past the guard's 29 (views, nothing allocated)
    rowcum = torch.zeros((1, 1, 1), dtype=torch.int32).expand(30, 4362, 4148)
    with pytest.raises(ValueError, match="too tall"):
        tcomp.compact_from_rowcum_flat(rowcum, rowcum)
    pc = torch.zeros((1, 1, 1), dtype=torch.int32).expand(30, 4362, 136)
    with pytest.raises(ValueError, match="too tall"):
        tcomp.compact_from_words_flat(rowcum, pc, pc)


# --- the stage-timing tool's stage functions, at a small size --------------


@pytest.fixture
def stages_ctx(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    from ffs_tpu_torch.tools import measure_stages as ms

    mask = np.ones((96, 256), np.uint8)
    mask[40:44] = 0
    mask[:, 120:123] = 0
    frames = ms.make_batch(2, mask, spots=25, seed=12)
    assert frames.shape == (2, 96, 256) and frames.dtype == np.uint16
    ctx = ms.StageContext.build(mask, max_px=512, max_spots=256, flat_px=768, flat_spots=384)
    assert ctx.mask.device.type == "cpu"
    return ms, ctx, frames, mask


def _jax_rowcum(frames, mask, i):
    bb = jnp.asarray(frames) + (i & 1)
    _, rowcum = j_fused(bb, jnp.asarray(mask), TM, mbox=j_mbox(jnp.asarray(mask)),
                        emit_strong=False, interpret=True)
    return bb, rowcum


def _assert_table(got, want):
    for name in jcc.SpotTable._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)


def _jax_full(p, w, max_spots, frame_rows=None):
    root = jcc.label_compact_pixels(p, width=w)
    t = jcc.spot_table_from_pixels(p, root, width=w, max_spots=max_spots, dtype=jnp.float32,
                                   frame_rows=frame_rows)
    # the JAX tool runs with x64 off, where the separation test is float32
    with jax.enable_x64(False):
        keep, _, _ = jcc.filter_spots(t, 3, 2.0)
    return root, t, keep


@pytest.mark.parametrize("i", [0, 1])
def test_measure_stages_prefixes_match_jax(stages_ctx, i):
    ms, ctx, frames, mask = stages_ctx
    w = frames.shape[-1]
    bb, rowcum = _jax_rowcum(frames, mask, i)
    batch = torch.from_numpy(frames)

    total, (rc,) = ms.k_only(i, batch, ctx)
    np.testing.assert_array_equal(rc.numpy(), np.asarray(rowcum))
    assert float(total) == float(np.asarray(rowcum)[:, :, -1].sum())

    _, per_frame = ms.k_full(i, batch, ctx)
    assert len(per_frame) == 2
    n_spots = 0
    for b, (p, root, t, keep) in enumerate(per_frame):
        jp = jcomp.compact_from_rowcum(bb[b], rowcum[b], max_pixels=ctx.max_px)
        _assert_pixels_equal(p, jp)
        jroot, jt, jkeep = _jax_full(jp, w, ctx.max_spots)
        np.testing.assert_array_equal(root.numpy(), np.asarray(jroot))
        _assert_table(t, jt)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        n_spots += int(t.n_spots)
    assert n_spots > 10

    _, (p, root, t, keep) = ms.flat_full(i, batch, ctx)
    jp = jcomp.compact_from_rowcum_flat(bb, rowcum, max_pixels_total=ctx.flat_px)
    _assert_pixels_equal(p, jp)
    jroot, jt, jkeep = _jax_full(jp, w, ctx.flat_spots, frame_rows=frames.shape[1])
    np.testing.assert_array_equal(root.numpy(), np.asarray(jroot))
    _assert_table(t, jt)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


def test_measure_stages_packed_rows_match_jax(stages_ctx):
    ms, ctx, frames, mask = stages_ctx
    w = frames.shape[-1]
    bb = jnp.asarray(frames) + 1
    words, pc = j_packed(bb, jnp.asarray(mask), TM, mbox=j_mbox(jnp.asarray(mask)), interpret=True)
    _, (p, root, t, keep) = ms.pk_full(1, torch.from_numpy(frames), ctx)
    jp = jcomp.compact_from_words_flat(bb, words, pc, max_pixels_total=ctx.flat_px)
    _assert_pixels_equal(p, jp)
    jroot, jt, jkeep = _jax_full(jp, w, ctx.flat_spots, frame_rows=frames.shape[1])
    np.testing.assert_array_equal(root.numpy(), np.asarray(jroot))
    _assert_table(t, jt)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    # the extended row's rowcum, against the JAX extended entry
    _, (rc,) = ms.ext_only(1, torch.from_numpy(frames), ctx)
    _, jrc = j_ext_fused(bb, jnp.asarray(mask), TM, emit_strong=False, interpret=True)
    np.testing.assert_array_equal(rc.numpy(), np.asarray(jrc))


def test_measure_stages_main_runs_on_the_cpu(stages_ctx, capsys):
    ms, ctx, frames, _ = stages_ctx
    rows = ms.run_rows(ctx, torch.from_numpy(frames), ms.MAIN_ROWS + ms.PACKED_ROWS, reps=1)
    out = capsys.readouterr().out
    assert "host CPU" in out and len(rows) == len(ms.MAIN_ROWS) + len(ms.PACKED_ROWS)
    assert all(ms_ > 0 for ms_ in rows.values())
