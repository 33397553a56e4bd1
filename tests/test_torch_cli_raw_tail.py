"""The batched CLI with ``--decode-backend device`` on a frame whose pixel
count is not a multiple of 8, ffs_tpu's CLI against the port's.

Every bitshuffle-LZ4 chunk of such a frame ends in a raw tail of
``n_px % 8`` elements, which the batched device decode does not take (its
planes hold whole 8-element groups): the /dev/shm reader hands over no
planes for it and both CLIs decode those frames on the host.  Bench.py's
Jungfrau 1M frame, 1066 x 1030 = 1,097,980 px, is such a frame; here a
34 x 30 = 1020 px dump stands in for it (the JAX CLI runs its Pallas
kernels in interpret mode, the port its kernels' plain versions).  Both
must exit alike, print the same "unavailable" notices (none) and the same
pipe lines.  Tolerance: none.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ffs_tpu_torch.io import compression

H, W = 34, 30
N_FRAMES = 5  # two batches of 2 and a tail of 1


@pytest.fixture(scope="module")
def tail_dump(tmp_path_factory):
    """A /dev/shm-style stream dump of seeded 34 x 30 u16 frames: Poisson(2)
    with 3 x 3 spots, a masked column."""
    assert (H * W) % 8 == 4
    d = tmp_path_factory.mktemp("shm_tail")
    rng = np.random.default_rng(34)
    mask = np.ones((H, W), np.uint8)
    mask[:, 17] = 0
    header = {
        "nimages": N_FRAMES, "ntrigger": 1, "y_pixels_in_detector": H,
        "x_pixels_in_detector": W, "bit_depth_image": 16,
        "countrate_correction_count_cutoff": 65535, "wavelength": 0.976,
        "detector_distance": 500.0, "y_pixel_size": 7.5e-05, "x_pixel_size": 7.5e-05,
        "beam_center_y": H / 2, "beam_center_x": W / 2,
    }
    (d / "start_1").write_text(json.dumps(header))
    (d / "start_4").write_text("{}")
    (d / "start_5").write_bytes((mask == 0).astype(np.int32).tobytes())
    for i in range(N_FRAMES):
        frame = rng.poisson(2.0, size=(H, W)).astype(np.uint16)
        for y, x in rng.integers(2, min(H, W) - 2, size=(3 + i, 2)):
            frame[y - 1 : y + 2, x - 1 : x + 2] += rng.poisson(40, size=(3, 3)).astype(np.uint16)
        frame[mask == 0] = 0
        (d / f"image_{i:06d}_2").write_bytes(compression.bshuf_lz4_compress(frame, 2))
    return d


def _start(package, args, cwd, extra):
    """The CLI in a subprocess of its own, its pipe line fd passed down."""
    cwd.mkdir()
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "FFS_TORCH_DEVICE": "cpu"}, **extra)
    r, w = os.pipe()
    os.set_inheritable(w, True)
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{package}.pipeline.spotfinder", *args, "--pipe_fd", str(w)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=cwd, env=env, pass_fds=(w,),
    )
    os.close(w)
    return proc, r


def _finish(proc, r):
    """(exit code, stdout, pipe lines); the pipe drains before the wait."""
    with os.fdopen(r) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    out, _ = proc.communicate(timeout=600)
    return proc.returncode, out.decode(), lines


@pytest.mark.parametrize("algorithm", ["dispersion", "dispersion_extended"])
def test_cli_device_decode_raw_tail_matches_jax(algorithm, tail_dump, tmp_path):
    args = [str(tail_dump), "--precision", "f32", "--batch", "2", "--decode-backend", "device",
            "--algorithm", algorithm, "--min-spot-size", "1"]
    # both CLIs at once: the test waits for the slower, not for the sum
    jax_run = _start("ffs_tpu", args, tmp_path / "jax", {"FFS_PALLAS_INTERPRET": "1"})
    torch_run = _start("ffs_tpu_torch", args, tmp_path / "torch", {"FFS_TORCH_KERNEL_PATH": "1"})
    t_rc, t_log, t_lines = _finish(*torch_run)
    j_rc, j_log, j_lines = _finish(*jax_run)
    assert t_rc == j_rc, t_log + j_log
    notices = [[ln for ln in log.splitlines() if "unavailable" in ln] for log in (j_log, t_log)]
    assert notices[1] == notices[0]
    assert t_lines == j_lines
    assert j_rc == 0 and notices[0] == [], j_log  # what ffs_tpu's CLI does there
    assert [ln["file-number"] for ln in j_lines] == list(range(N_FRAMES))
    assert sum(ln["num_strong_pixels"] for ln in j_lines) > 0
    assert "Device: cpu" in t_log
