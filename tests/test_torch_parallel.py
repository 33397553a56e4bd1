"""The port's multi-device functions (ffs_tpu_torch.parallel over gloo, one
process a rank, on the CPU) against ffs_tpu.parallel on the virtual CPU
mesh, at 2 and 4 ranks.

Every case of a world runs in one spawn (tests/torch_parallel_ranks.py);
the JAX side runs ``make_mesh(n)`` on the conftest's virtual devices with
Pallas in interpret mode, as tests/test_parallel.py does.  Results are
equal, bit for bit; the rotation's tall indices differ by their pitch (the
JAX pitch counts its Pallas strip padding), so the frame-local pixels,
per-frame counts and 3D spots are compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffs_tpu import parallel as jpar
from ffs_tpu.ops import cc3d as jcc3d
from ffs_tpu.ops import dispersion as jdops
from ffs_tpu.parallel import mesh as jmesh_mod
from ffs_tpu_torch.ops import cc3d as tcc3d
from ffs_tpu_torch.parallel import mesh as pm
from ffs_tpu_torch.parallel.launch import RankError, run_ranks

from . import torch_parallel_ranks as ranks

TRUSTED = ranks.TRUSTED


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request):
    if len(jax.devices()) < request.param:
        pytest.skip(f"needs {request.param} virtual devices")
    return request.param


@pytest.fixture(scope="module")
def port(world):
    """Every rank's results of ranks.rank_cases, in rank order."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FFS_TORCH_DEVICE", "cpu")
        return run_ranks(ranks.rank_cases, world, backend="gloo", args=(world,), timeout=300)


@pytest.fixture(scope="module")
def inp(world):
    return ranks.inputs(world)


@pytest.fixture(scope="module")
def jm(world):
    return jpar.make_mesh(world)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _j(a):
    return jnp.asarray(a)


def test_runs_every_rank_in_order_on_the_cpu(world, port):
    assert [r["rank"] for r in port] == list(range(world))
    assert {r["device"] for r in port} == {"cpu"}


def test_counts_match_jax(world, port, inp, jm):
    pf, total = jpar.sharded_spotfind_counts(jm, _j(inp["frames"]), _j(inp["mask"]), TRUSTED)
    assert int(total) == int(np.asarray(pf).sum()) > 0
    for r in port:
        np.testing.assert_array_equal(_np(r["counts"][0]), np.asarray(pf))
        assert int(r["counts"][1]) == int(total)


def test_halo_sharded_dispersion_matches_jax(world, port, inp, jm):
    img = inp["halo"]
    mask = np.ones_like(img, dtype=np.uint8)
    want = np.asarray(jpar.halo_sharded_dispersion(jm, _j(img), _j(mask), TRUSTED))
    single = np.asarray(jdops.dispersion(_j(img), _j(mask), TRUSTED, dtype=jnp.float32))
    np.testing.assert_array_equal(want.astype(bool), single)
    assert single[60:68, 90:94].any()
    for r in port:
        assert r["halo"].dtype == torch.bool
        np.testing.assert_array_equal(_np(r["halo"]), single)


def test_shard_frames_gives_each_rank_its_slice(world, port, inp):
    k = len(inp["frames"]) // world
    for rank, r in enumerate(port):
        np.testing.assert_array_equal(_np(r["shard"]), inp["frames"][rank * k : (rank + 1) * k])


@pytest.fixture(scope="module")
def jax_packed(world, inp, jm):
    return jpar.sharded_packed_pipeline(
        jm, _j(inp["frames"]), _j(inp["mask"]), TRUSTED, max_pixels_per_frame=ranks.KF,
        max_spots_per_chip=ranks.KF, interpret=True)


def test_packed_pipeline_matches_jax(world, port, jax_packed):
    pf, spots, total = (np.asarray(x) for x in jax_packed)
    assert spots.shape == (world,) and spots.sum() > 0 and int(total) == pf.sum() > 0
    for r in port:
        for got, want in zip(r["packed"], (pf, spots, total)):
            np.testing.assert_array_equal(_np(got), want)


def test_planes_pipeline_matches_jax(world, port, inp, jm, jax_packed):
    got_jax = jmesh_mod.sharded_packed_pipeline_planes(
        jm, _j(inp["planes"]), inp["frames"].shape[1:], np.uint16, _j(inp["mask"]), TRUSTED,
        max_pixels_per_frame=ranks.KF, max_spots_per_chip=ranks.KF, interpret=True)
    for g, p in zip(got_jax, jax_packed):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(p))
    for r in port:
        for got, want in zip(r["planes"], jax_packed):
            np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("key", ["sp", "ext"], ids=["plain", "extended"])
def test_sp_table_matches_jax(world, port, inp, jm, key):
    frame = inp[key]
    mask = np.ones_like(frame, dtype=np.uint8)
    table, total = jpar.sharded_packed_sp_pipeline(
        jm, _j(frame), _j(mask), TRUSTED, max_pixels_per_chip=ranks.SP_K,
        max_spots=ranks.SP_SPOTS, interpret=True, extended=key == "ext")
    ns = int(table.n_spots)
    assert ns > 0 and int(total) > 0
    for r in port:
        got, got_total = r[key]
        assert int(got.n_spots) == ns and int(got_total) == int(total)
        for field in table._fields:
            if field != "n_spots":
                np.testing.assert_array_equal(
                    _np(getattr(got, field))[:ns], np.asarray(getattr(table, field))[:ns],
                    err_msg=f"column {field}")
        # the merge ran more than its closing round: components did cross
        assert r[key + "_rounds"] >= 2
    # a component spanning shard boundaries came out whole
    n_px = np.asarray(table.n_pixels)[:ns]
    assert n_px.max() >= (50 * 2 if key == "sp" else 30)


def test_extended_halo_of_ten_rows_gives_the_same_bits(world, port):
    """ADVICE.md:3: first pass 3 + erosion 2 + second pass 5 = 10 rows
    suffice; the port keeps JAX's 11 (the same shapes raise), and a 10-row
    halo gives the same table."""
    for r in port:
        assert _same(r["ext_halo10"], r["ext"])


def _jax_kabsch(inp, a):
    """JAX's ``_block_step_impl`` on the set-up of the Kabsch case's first
    ``a`` reflections (padded to its max_active)."""
    from ffs_tpu.integration import kabsch as jkb

    integ, cs_e1, cs_e2, zeta = ranks.kabsch_setup(jkb.KabschIntegrator, inp)
    dev = integ._chunk_setup(np.arange(a), cs_e1, cs_e2, zeta)
    frames = jnp.asarray(integ.pad_frames(inp["kimage"])).astype(jnp.int32)
    phi_lows, d_osc, z_values, frame_ok = ranks.kabsch_block_args(len(inp["kimage"]))
    args = (_j(phi_lows), d_osc, _j(z_values), _j(frame_ok))
    return jax.jit(integ._block_step_impl, static_argnames=("centre_slices",))(
        frames, dev["e12"], dev["maskw"], dev["x0"], dev["y0"], dev["bbox"], dev["phi"],
        dev["zeta"], dev["active"], *args, centre_slices=True)


def _assert_kabsch(port, key, want):
    assert int(np.asarray(want[1]).sum()) > 0  # tests/test_parallel.py holds JAX's sharded step to it
    for r in port:
        assert len(r[key]) == 8
        for k, (g, w) in enumerate(zip(r[key], want)):
            np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=f"output {k}")


def test_kabsch_block_step_matches_jax(world, port, inp):
    _assert_kabsch(port, "kabsch", _jax_kabsch(inp, len(inp["kx"])))


@pytest.mark.parametrize("key", ["kabsch_local", "kabsch_local_short"])
def test_kabsch_step_on_each_ranks_own_set_up_matches_jax(world, port, inp, key):
    """sharded_chunk_setup: each rank sets up its own rows of the chunk,
    the whole chunk's dict bit for bit, for a full and a short chunk."""
    a = len(inp["kx"]) if key == "kabsch_local" else ranks.KABSCH_SHORT
    _assert_kabsch(port, key, _jax_kabsch(inp, a))


def test_rotation_matches_jax(world, port, inp, jm):
    k, kf = 2, ranks.KF
    lin, inten, rl, pf, pitch = jpar.sharded_rotation_compact(
        jm, _j(inp["rot"]), _j(inp["mask"]), TRUSTED, max_pixels_per_frame=kf, interpret=True)
    want = jpar.rotation_frame_pixels(lin, inten, rl, pf, pitch, kf, k)
    spots_want = jcc3d.merge_frames(want, width=inp["rot"].shape[-1])
    spans = (spots_want.z_min <= k - 1) & (spots_want.z_max >= k)
    assert spans.any(), "no 3D spot spans the rank-boundary frame pair"
    h, w = inp["rot"].shape[1:]
    for r in port:
        lin_t, inten_t, rl_t, pf_t, pitch_t = r["rotation"]
        assert pitch_t == (h + 1) * w  # the JAX pitch counts its strip padding
        np.testing.assert_array_equal(pf_t, np.asarray(pf))
        got = ranks.pm.rotation_frame_pixels(lin_t, inten_t, rl_t, pf_t, pitch_t, kf, k)
        for z, (a, b) in enumerate(zip(got, want)):
            for fld in ("linear_index", "intensity", "root"):
                np.testing.assert_array_equal(getattr(a, fld), getattr(b, fld),
                                              err_msg=f"frame {z} {fld}")
        spots = tcc3d.merge_frames(got, width=w)
        assert len(spots) == len(spots_want) > 0
        for fld in dataclasses.fields(jcc3d.Spots3D):
            np.testing.assert_array_equal(np.asarray(getattr(spots, fld.name)),
                                          np.asarray(getattr(spots_want, fld.name)),
                                          err_msg=fld.name)


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def test_replicated_outputs_identical_on_every_rank(world, port):
    for key in ("counts", "halo", "packed", "planes", "sp", "ext", "sp_rounds", "ext_rounds",
                "rotation", "kabsch", "kabsch_local", "kabsch_local_short", "guards", "dryrun"):
        for r in port[1:]:
            assert _same(r[key], port[0][key]), key


GUARDS = {  # guard -> (exception, message fragment)
    "counts_batch": ("ValueError", "must divide the mesh axis"),
    "packed_batch": ("ValueError", "must divide the mesh axis"),
    "planes_batch": ("ValueError", "must divide the mesh axis"),
    "rotation_batch": ("ValueError", "must divide the mesh axis"),
    "halo_rows": ("ValueError", "must divide the mesh axis"),
    "halo_short": ("ValueError", "must be >= the kernel radius"),
    "sp_rows": ("ValueError", "must divide the mesh axis"),
    "sp_extended_halo": ("ValueError", "must cover the halo (11)"),
    "kabsch_chunk": ("ValueError", "must divide the mesh axis"),
    "kabsch_setup_chunk": ("ValueError", "must divide the mesh axis"),
    "kabsch_setup_overflow": ("ValueError", "exceeds max_active"),
    "packed_overflow": ("RuntimeError", "exceeding max_pixels_per_frame=4"),
    "sp_spot_overflow": ("RuntimeError", "exceeding max_spots=2"),
    "sp_pixel_overflow": ("RuntimeError", "exceeding max_pixels_per_chip=8"),
    "rotation_overflow": ("RuntimeError", "exceeding max_pixels_per_frame=4"),
}


def _jax_guard(name, jm, inp, n):
    """The JAX function's raise for the same guard case (None where it has
    no such guard: its spotfind counts fail in device_put instead)."""
    img = inp["halo"]
    ones = np.ones_like(img, dtype=np.uint8)
    odd = np.ones((2 * n + 1, 8, 8), np.uint16)
    sp = inp["sp"]
    calls = {
        "packed_batch": lambda: jpar.sharded_packed_pipeline(
            jm, _j(odd), _j(ones[:8, :8]), TRUSTED, interpret=True),
        "planes_batch": lambda: jmesh_mod.sharded_packed_pipeline_planes(
            jm, _j(inp["planes"][: 2 * n - 1]), inp["frames"].shape[1:], np.uint16,
            _j(inp["mask"]), TRUSTED, interpret=True),
        "rotation_batch": lambda: jpar.sharded_rotation_compact(
            jm, _j(odd), _j(ones[:8, :8]), TRUSTED, interpret=True),
        "halo_rows": lambda: jpar.halo_sharded_dispersion(
            jm, _j(img[: 8 * n + 1]), _j(ones[: 8 * n + 1]), TRUSTED),
        "halo_short": lambda: jpar.halo_sharded_dispersion(
            jm, _j(img[: 2 * n]), _j(ones[: 2 * n]), TRUSTED),
        "sp_rows": lambda: jpar.sharded_packed_sp_pipeline(
            jm, _j(img[: 8 * n + 1]), _j(ones[: 8 * n + 1]), TRUSTED, interpret=True),
        "sp_extended_halo": lambda: jpar.sharded_packed_sp_pipeline(
            jm, _j(img[: 8 * n]), _j(ones[: 8 * n]), TRUSTED, interpret=True, extended=True),
        "kabsch_chunk": lambda: jpar.sharded_kabsch_block_step(
            jm, None, None, {"x0": np.zeros(2 * n + 1)}, None, 0.0, None, None),
        "packed_overflow": lambda: jpar.sharded_packed_pipeline(
            jm, _j(inp["frames"]), _j(inp["mask"]), TRUSTED, max_pixels_per_frame=4,
            interpret=True),
        "sp_spot_overflow": lambda: jpar.sharded_packed_sp_pipeline(
            jm, _j(sp), _j(np.ones_like(sp, dtype=np.uint8)), TRUSTED,
            max_pixels_per_chip=ranks.SP_K, max_spots=2, interpret=True),
        "sp_pixel_overflow": lambda: jpar.sharded_packed_sp_pipeline(
            jm, _j(sp), _j(np.ones_like(sp, dtype=np.uint8)), TRUSTED,
            max_pixels_per_chip=8, interpret=True),
        "rotation_overflow": lambda: jpar.sharded_rotation_compact(
            jm, _j(inp["rot"]), _j(inp["mask"]), TRUSTED, max_pixels_per_frame=4,
            interpret=True),
    }
    if name not in calls:
        return None
    with pytest.raises((ValueError, RuntimeError)) as e:
        calls[name]()
    return e.type.__name__, str(e.value)


@pytest.mark.parametrize("guard", sorted(GUARDS))
def test_guard_raises_on_every_rank_as_in_jax(world, port, inp, jm, guard):
    kind, fragment = GUARDS[guard]
    raised = [r["guards"][guard] for r in port]
    assert raised[0] is not None and raised[0][0] == kind and fragment in raised[0][1]
    assert all(x == raised[0] for x in raised)  # every rank raised, the same
    want = _jax_guard(guard, jm, inp, world)
    if want is not None:
        assert raised[0] == want


def test_halo_exchange_edge_fills(world, port):
    from ffs_tpu_torch.ops.connected_components import BIG

    block = np.arange(12, dtype=np.int32).reshape(4, 3)
    for rank, r in enumerate(port):
        for key, rows, fill in (("zero", 2, 0), ("big", 1, BIG)):
            got = _np(r["fills"][key])
            assert got.shape == (4 + 2 * rows, 3)
            np.testing.assert_array_equal(got[rows:-rows], block + 100 * rank)
            above = block[-rows:] + 100 * (rank - 1) if rank else np.full((rows, 3), fill)
            below = block[:rows] + 100 * (rank + 1) if rank < world - 1 else np.full((rows, 3), fill)
            np.testing.assert_array_equal(got[:rows], above, err_msg=f"{key} above")
            np.testing.assert_array_equal(got[-rows:], below, err_msg=f"{key} below")
        u16 = r["fills"]["u16"]
        assert u16.dtype == torch.uint16
        np.testing.assert_array_equal(u16.view(torch.int16).numpy(), _np(r["fills"]["zero"]))


def test_dryrun_matches_jax(world, port):
    rng = np.random.default_rng(1)
    batch = rng.poisson(3.0, size=(2 * world, 64, 256)).astype(np.uint16)
    batch[:, 30:33, 100:103] = 800
    want = np.asarray(jdops.dispersion(_j(batch), jnp.ones((64, 256), jnp.uint8), TRUSTED,
                                       dtype=jnp.float32)).sum(axis=(1, 2))
    summary = port[0]["dryrun"]
    assert summary["dp_per_frame"] == want.tolist()
    assert min(summary["sp_spots"], summary["sp_extended_spots"], summary["rotation_spots"],
               summary["kabsch_fg_pixels"]) > 0


def test_searchsorted_left_matches_jax():
    """The SP merge's root lookup: torch.searchsorted(right=False) is the
    JAX package's unrolled side='left' search for every query up to the
    largest value, duplicates and BIG padding included.  The merge asks no
    other: a root is a pixel in the sorted list, and a BIG root is replaced
    by its own slot.  Above the largest value the unrolled search runs past
    the end (up to n + 1) where torch stops at n."""
    from ffs_tpu.ops.connected_components import BIG, _searchsorted

    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 64, 1000):
        vals = rng.integers(0, 50, n).astype(np.int32)
        vals[rng.random(n) < 0.3] = BIG
        vals = np.sort(vals)
        inside = np.concatenate([vals, rng.integers(-5, 60, 50).astype(np.int32)])
        inside = inside[inside <= vals.max()]
        above = np.array([vals.max() + 1, BIG + 1], np.int32)
        for queries in (inside, above):
            want = np.asarray(_searchsorted(jnp.asarray(vals), jnp.asarray(queries)))
            got = torch.searchsorted(torch.from_numpy(vals), torch.from_numpy(queries),
                                     right=False).numpy()
            if queries is inside:
                np.testing.assert_array_equal(got, want)
            else:
                assert (got == n).all() and (want >= n).all()


@pytest.mark.parametrize("how", ["raise", "exit"])
def test_run_ranks_fails_on_a_lone_rank_without_hanging(monkeypatch, how):
    """Rank 1 fails alone while rank 0 waits in a collective: the call
    raises (with rank 1's traceback when it raised) well inside its timeout."""
    import time

    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    t0 = time.monotonic()
    with pytest.raises(RankError) as e:
        run_ranks(ranks.lone_failure, 2, backend="gloo", args=(how,), timeout=120)
    assert time.monotonic() - t0 < 90
    if how == "raise":
        assert "rank 1 of 2 failed" in str(e.value) and "rank 1 fails alone" in str(e.value)


def test_make_mesh_refuses_outside_a_rank_and_a_wrong_backend(monkeypatch):
    with pytest.raises(RuntimeError, match="inside a rank"):
        pm.make_mesh()
    with pytest.raises(ValueError, match="backend"):
        run_ranks(ranks.lone_failure, 2, backend="mpi")
