"""spotfinder CLI on PyTorch — per-image analysis executable.

Counterpart of :mod:`ffs_tpu.pipeline.spotfinder` with the same argument
surface but ``--compact-backend`` (the port compacts strong pixels on the
device only), the same JSON-over-pipe protocol, scraped log lines (``Thread .. finished
image .. with .. strong pixels``, ``Calculated N spots``, ``Filtered N spots
with size < K pixels``), exit-code-32 bit-depth renegotiation, ``--validate``,
``--profile``, streaming 3D merge and ``results_ffs.h5``; ``--batch B``
runs frames through the batched path and ``--decode-backend device`` ships
the LZ4-decoded bitshuffle planes to the card, which decodes them there
(both need the kernel path: ``--precision f32`` on a CUDA device);
``--jax-profile DIR`` writes a ``torch.profiler`` trace of the collection
loop and the loop's spans (:mod:`..utils.tracing`); every run ends with
one ``{"ffs_trace": ...}`` line of counters.  :func:`run` parses the
arguments, sets up the reader, geometry, processor and pipe, runs the
collection loop (:mod:`.collection`, which holds its queue rules) and
writes the epilogue.  The reader and algorithm-name helpers are copies of
the JAX CLI's (they touch no framework).

Test hook: ``FFS_TORCH_KERNEL_PATH=1`` turns the kernel path on for a CPU
device, where the kernels' plain PyTorch versions run, so that the batched
path and device decode run in the CPU tests (the JAX CLI's
``FFS_PALLAS_INTERPRET``).  It changes nothing on a CUDA device.

Console scripts: ``spotfinder_torch`` and ``spotfinder32_torch``; the
service runs them through its SPOTFINDER / SPOTFINDER_32BIT variables.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

import numpy as np


def _make_reader(args):
    from ..io.sample_data import SampleReader

    if args.sample or (not args.file and os.getenv("H5READ_IMPLICIT_SAMPLE")):
        return SampleReader(num_images=args.images)
    path = args.file
    deadline = time.monotonic() + args.timeout
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.1)
    if not os.path.exists(path):
        print(f"Timeout waiting for {path}")
        sys.exit(1)
    if os.path.isdir(path):
        from ..io import shm

        while not shm.is_ready_for_read(path) and time.monotonic() < deadline:
            time.sleep(0.1)
        return shm.SHMRead(path)
    if path.endswith(".cbf"):
        if args.images is None:
            print("Error: CBF reading must specify --images")
            sys.exit(1)
        from ..io.cbf import CBFRead

        return CBFRead(path, args.images, args.start_index)
    from ..io.nexus import NexusReader

    return NexusReader(path)


class _DispersionAlgorithm:
    def __init__(self, name: str):
        low = name.lower()
        if low == "dispersion":
            self.pretty = "Dispersion"
        elif low == "dispersion_extended":
            self.pretty = "Dispersion Extended"
        else:
            raise SystemExit(f"Invalid algorithm specified: {name}")
        self.name = low


def _env_choice(name: str, default: str, choices: tuple[str, ...]) -> str:
    value = os.environ.get(name, default)
    if value not in choices:
        # argparse does not validate defaults against choices
        print(f"Warning: Ignoring invalid {name} value:", value)
        return default
    return value


def _build_parser(version: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="spotfinder", description="GPU spotfinder (PyTorch)")
    # input selection is validated in run() so --list-devices works bare
    group = p.add_mutually_exclusive_group(required=False)
    group.add_argument("--sample", action="store_true", help="Use generated test data")
    group.add_argument("file", nargs="?", default="", metavar="FILE.nxs")
    p.add_argument("--version", action="version", version=version)
    from ..utils.cli import add_common_arguments

    add_common_arguments(p)
    p.add_argument("--list-devices", action="store_true")
    p.add_argument("--device", type=int, default=0)
    p.add_argument("-n", "--threads", type=int, default=1, metavar="NUM")
    p.add_argument("--validate", action="store_true")
    p.add_argument("--images", type=int, default=None, metavar="NUM")
    p.add_argument("--writeout", action="store_true")
    p.add_argument("--min-spot-size", type=int, default=3, metavar="N")
    p.add_argument("--min-spot-size-3d", type=int, default=3, metavar="N")
    p.add_argument("--max-peak-centroid-separation", type=float, default=2.0, metavar="N")
    p.add_argument("--start-index", type=int, default=0, metavar="N")
    default_timeout = 30.0
    if os.getenv("SPOTFINDER_TIMEOUT"):
        try:
            default_timeout = float(os.environ["SPOTFINDER_TIMEOUT"])
        except ValueError:
            print(
                "Warning: Ignoring invalid SPOTFINDER_TIMEOUT value:",
                os.environ["SPOTFINDER_TIMEOUT"],
            )
    p.add_argument("-t", "--timeout", type=float, default=default_timeout, metavar="S")
    p.add_argument("-fd", "--pipe_fd", type=int, default=-1, metavar="FD")
    p.add_argument("-a", "--algorithm", default="dispersion", metavar="ALGO")
    p.add_argument("--dmin", type=float, default=-1.0, metavar="MIN D")
    p.add_argument("--dmax", type=float, default=-1.0, metavar="MAX D")
    # "-λ" short alias matches the reference parser (spotfinder.cc:382)
    p.add_argument("-w", "-λ", "--wavelength", type=float, default=None, metavar="λ")
    p.add_argument("--detector", default=None, metavar="JSON")
    p.add_argument("-h5", "--save-h5", action="store_true")
    p.add_argument("--output-for-index", action="store_true")
    p.add_argument(
        "--pixel-depth",
        type=int,
        default=None,
        help="Expected pixel bit depth (exit with the data's depth on mismatch,"
        " mirroring the reference's two-binary protocol)",
    )
    p.add_argument(
        "--precision",
        choices=["f64", "f32"],
        default="f64",
        help="Decision arithmetic precision (f64 = DIALS bit-parity; f32 runs"
        " the packed CUDA kernels on a GPU)",
    )
    p.add_argument(
        "--batch",
        type=int,
        default=1,
        metavar="B",
        help="Process frames in device batches of B through the batched path"
        " (one kernel launch per batch, segmented per-frame compaction) to"
        " amortise per-frame overhead.  Requires the kernel path (--precision"
        " f32 on a GPU); falls back to per-frame otherwise.  Incompatible with"
        " --profile (which times stages per frame).",
    )
    p.add_argument(
        "--decode-backend",
        choices=["host", "device"],
        default=_env_choice("FFS_SPOTFIND_DECODE", "host", ("host", "device")),
        help="Where the bitshuffle untranspose runs.  'device' has the reader"
        " threads stop at the LZ4 stage and uploads the bit-plane buffers,"
        " which a CUDA kernel turns into frames inside the batch.  Requires"
        " --batch on the kernel path and a bitshuffle-LZ4 source; falls back"
        " to host decode otherwise.  Env default: FFS_SPOTFIND_DECODE.",
    )
    p.add_argument(
        "--profile",
        action="store_true",
        help="Per-image stage timing breakdown (upload/kernel/compact/post),"
        " mirroring the reference's CUDA-event per-image report; disables"
        " the dispatch-ahead pipeline so stages time individually",
    )
    p.add_argument(
        "--jax-profile",
        metavar="DIR",
        default=None,
        help="Write a torch.profiler trace (Chrome trace JSON, CPU and CUDA"
        " activity) of the collection loop into DIR; the flag keeps the JAX"
        " CLI's name.  Composable with --batch; unlike --profile it keeps the"
        " dispatch-ahead pipeline intact.  It also records the loop's spans"
        " (on the main thread, named in the trace: ffs.reader_wait,"
        " ffs.submit, ffs.decode_wait, ffs.stack, ffs.upload, ffs.dispatch,"
        " ffs.collect, ffs.push3d, ffs.emit, ffs.release; recorded only:"
        " ffs.fetch on the reader threads, ffs.inflight, ffs.batch_fill (a"
        " frame's wait for its batch to fill, --batch), ffs.setup,"
        " ffs.epilogue), writes them to DIR/spans.json on the trace's time"
        " base, and sums them in one line at the end, {\"ffs_trace\": ...}."
        "  That line is printed without the flag too, with the counters only:"
        " frames_in, lines_out, batches, h2d_bytes (frames or planes passed"
        " to the device), fallback_batch_overflow (frames past the batched"
        " capacity, run per frame), fallback_host_decode (frames of a mixed"
        " batch, decoded on the host although device decode is on),"
        " device_decode_frames (frames whose bit planes became frames on the"
        " device), host_decode_vector (frames whose bitshuffle-LZ4 decode on"
        " the host took the vector untranspose), f64_walker_frames (frames"
        " whose float64 threshold ran as the float64 walker),"
        " idle_drain_frames (frames emitted while intake found the next"
        " image not there yet), and the kernels' launches.",
    )
    return p


def run(argv=None, default_pixel_depth: int = 16) -> int:
    t_entry = time.time_ns()
    from ..models.geometry import Scan, simple_panel
    from ..models.reflection_table import ReflectionTable
    from ..ops import cc3d
    from ..utils.cli import apply_verbosity, expand_common_args

    from .. import __version__
    from ..ops import kernel_wrappers
    from ..spotfind import SpotfindConfig, SpotfindProcessor
    from ..utils import torchinit, tracing
    from .collection import Collection

    torchinit.setup()
    print(f"Spotfinder version: {__version__}")
    args = _build_parser(__version__).parse_args(expand_common_args(argv))
    apply_verbosity(args)
    tracing.start(bool(args.jax_profile))

    # Cooperative SIGINT cancellation (reference: spotfinder.cc:43-54,603):
    # the first Ctrl-C stops image intake so the epilogue still runs; a
    # second Ctrl-C exits immediately.
    stop = threading.Event()

    def _sigint(_signum, _frame):
        if stop.is_set():
            print("Second interrupt received; exiting immediately", flush=True)
            os._exit(130)
        stop.set()
        print(
            "Interrupt received; stopping intake (interrupt again to exit "
            "immediately)",
            flush=True,
        )

    try:
        signal.signal(signal.SIGINT, _sigint)
    except ValueError:
        pass  # not the main thread (e.g. called from tests)

    if args.list_devices:
        for line in torchinit.list_devices():
            print(line)
        return 0

    if not args.sample and not args.file and not os.getenv("H5READ_IMPLICIT_SAMPLE"):
        print("Error: one of the arguments --sample FILE.nxs is required")
        return 2

    device = torchinit.select_device(args.device)
    print(f"Device: {device} ({torchinit.device_name(device)})")

    algo = _DispersionAlgorithm(args.algorithm)
    print(f"Algorithm: {algo.pretty}")

    if args.threads < 1:
        print("Error: Thread count must be >= 1")
        return 1

    reader = _make_reader(args)

    # bit-depth renegotiation (reference: spotfinder.cc:466-476 exits with
    # the data's bit count; the service relaunches spotfinder32 on code 32)
    bytes_per_pixel = reader.get_element_size()
    expected_depth = args.pixel_depth or default_pixel_depth
    if bytes_per_pixel * 8 != expected_depth:
        print(
            f"Error: Data type mismatch; This executable only accepts "
            f"{expected_depth} bit != {bytes_per_pixel * 8}"
        )
        return bytes_per_pixel * 8

    num_images = args.images if args.images is not None else reader.get_number_of_images()
    height, width = reader.image_shape
    trusted_max = reader.get_trusted_range()[1]

    # detector geometry (reference: masking.cuh:32-69 JSON semantics —
    # values in mm, beam centre divided through by pixel size)
    if args.detector:
        g = json.loads(args.detector)
        px_x = g["pixel_size_x"] / 1000.0
        px_y = g["pixel_size_y"] / 1000.0
        detector = {
            "pixel_size_x": px_x,
            "pixel_size_y": px_y,
            "beam_center_x": g["beam_center_x"] / (px_x * 1000),
            "beam_center_y": g["beam_center_y"] / (px_y * 1000),
            "distance": g["distance"] / 1000.0,
        }
    else:
        beam_center = reader.get_beam_center()
        pixel_size = reader.get_pixel_size()
        distance = reader.get_detector_distance()
        if beam_center is None or pixel_size is None or distance is None:
            print(
                "Error: No detector geometry available from file. "
                "Please pass detector metadata with --detector."
            )
            return 1
        detector = {
            "pixel_size_x": pixel_size[1],
            "pixel_size_y": pixel_size[0],
            "beam_center_x": beam_center[1],
            "beam_center_y": beam_center[0],
            "distance": distance,
        }

    if args.wavelength is not None:
        wavelength = args.wavelength
    else:
        wavelength = reader.get_wavelength()
        if wavelength is None:
            print(
                "Error: No wavelength provided. Please pass wavelength using: "
                "--wavelength"
            )
            return 1
        print(f"Got wavelength from file: {wavelength:f} Å")

    print(
        "Detector geometry:\n"
        f"    Distance:    {detector['distance'] * 1000:.1f} mm\n"
        f"    Beam Center: {detector['beam_center_x']:.1f} px "
        f"{detector['beam_center_y']:.1f} px\n"
        f"Beam Wavelength: {wavelength:.2f} Å"
    )

    oscillation_start, oscillation_width = reader.get_oscillation()
    if oscillation_width > 0:
        print(
            f"Oscillation:  Start: {oscillation_start:.2f}°  "
            f"Width: {oscillation_width:.2f}°"
        )

    print(f"Image:       {width:4d} x {height:4d} = {width * height} px")
    print(f"Running with {args.threads} CPU threads")

    config = SpotfindConfig(
        algorithm=algo.name,
        min_spot_size=args.min_spot_size,
        min_spot_size_3d=args.min_spot_size_3d,
        max_peak_centroid_separation=args.max_peak_centroid_separation,
        dmin=args.dmin,
        dmax=args.dmax,
        precision=args.precision,
    )
    if os.environ.get("FFS_TORCH_KERNEL_PATH") and device.type == "cpu":
        # test hook: the kernel path (and with it --batch and device decode)
        # on the CPU, through the kernels' plain versions
        config.use_kernel = True
    mask = reader.get_mask()
    if mask is None:
        mask = np.ones((height, width), dtype=np.uint8)
    processor = SpotfindProcessor(
        width, height, mask, trusted_max, config, wavelength, detector, device=device
    )

    pipe = None
    if args.pipe_fd != -1:
        print(f"PipeHandler initialized with pipe_fd: {args.pipe_fd}")
        pipe = os.fdopen(args.pipe_fd, "w")

    rotation = oscillation_width > 0
    print(f"Dataset type: {'Rotation set' if rotation else 'Still set'}")

    all_images_start = time.monotonic()
    loop = Collection(args, reader, processor, mask, num_images=num_images,
                      rotation=rotation, pipe=pipe, stop=stop)

    prof = None
    if args.jax_profile:
        # trace of the whole collection region (intake, dispatch-ahead
        # pipeline, batch flushes), viewable in Perfetto or chrome://tracing
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()

    loop_t0 = tracing.stamp()
    tracing.record("ffs.setup", t_entry)
    try:
        loop.run()
    finally:
        loop_t1 = tracing.stamp()
        # stop even when the collection loop raises: the partial trace is
        # most wanted in a crash
        trace = None
        if prof is not None:
            prof.stop()
            os.makedirs(args.jax_profile, exist_ok=True)
            trace = os.path.join(args.jax_profile, "trace.json")
            prof.export_chrome_trace(trace)
            print(f"Torch profiler trace written to {trace}")
    loop.close()

    epilogue_t0 = tracing.stamp()

    # ----- epilogues (reference: spotfinder.cc:1099-1305) -------------------
    if rotation:
        print("Processing 3D spots")
        # frames still buffered (SIGINT / out-of-order tail) stream in
        # acquisition order
        for k in sorted(loop.rotation_slices):
            loop.merger.push_frame(loop.rotation_slices.pop(k))
        spots = loop.merger.finalize()
        print(f"Calculated {len(spots)} spots")
        keep, n_size, n_sep = cc3d.filter_spots(
            spots, args.min_spot_size_3d, args.max_peak_centroid_separation
        )
        if n_size > 0:
            print(f"Filtered {n_size} spots with size < {args.min_spot_size_3d} pixels")
        if n_sep > 0:
            print(
                f"Filtered {n_sep} spots with peak-centroid distance > "
                f"{args.max_peak_centroid_separation:g}"
            )
        kept = np.nonzero(keep)[0]
        print(f"Found {len(kept)} spots")

        # spot variances for integration (spotfinder.cc:1152-1216)
        panel = simple_panel(
            distance_mm=detector["distance"] * 1000,
            beam_center_px=(detector["beam_center_x"], detector["beam_center_y"]),
            pixel_size_mm=(
                detector["pixel_size_x"] * 1000,
                detector["pixel_size_y"] * 1000,
            ),
            image_size=(width, height),
        )
        scan = Scan(
            image_range=(1, num_images), oscillation=(oscillation_start, oscillation_width)
        )
        s0 = np.array([0.0, 0.0, -1.0 / wavelength])
        m2 = np.array([1.0, 0.0, 0.0])
        sb_var, sm_var, depth_v = cc3d.variances_in_kabsch_space(spots, panel, scan, s0, m2)
        sb_var, sm_var, depth_v = sb_var[kept], sm_var[kept], depth_v[kept]

        if len(kept):
            est_sigma_b = np.degrees(np.sqrt(sb_var.mean()))
            print(f"Estimated sigma_b (degrees): {est_sigma_b:.6f}")
        min_bbox_depth = 5
        deep = depth_v >= min_bbox_depth
        if deep.any():
            est_sigma_m = np.degrees(np.sqrt(sm_var[deep].mean()))
            print(
                f"Estimated sigma_m (degrees): {est_sigma_m:.6f}, "
                f"calculated on {int(deep.sum())} spots"
            )

        if args.writeout:
            with open("3d_reflections.txt", "w") as out:
                for s in kept:
                    out.write(
                        f"X: [{spots.x_min[s]}, {spots.x_max[s]}] "
                        f"Y: [{spots.y_min[s]}, {spots.y_max[s]}] "
                        f"Z: [{spots.z_min[s]}, {spots.z_max[s]}] "
                        f"COM: ({spots.com_x[s]:g}, {spots.com_y[s]:g}, "
                        f"{spots.com_z[s]:g})\n"
                    )

        if args.save_h5:
            table = ReflectionTable()
            coms = np.stack([spots.com_x[kept], spots.com_y[kept], spots.com_z[kept]], axis=1)
            table["xyzobs.px.value"] = coms
            table["id"] = np.full(len(kept), table.experiment_ids[0], dtype=np.int64)
            table["sigma_b_variance"] = sb_var
            table["sigma_m_variance"] = sm_var
            table["spot_extent_z"] = depth_v.astype(np.int64)
            table.write("results_ffs.h5")
            print("Successfully wrote 3D reflections to HDF5 file")
        print("3D spot analysis complete")
    elif args.save_h5:
        print("Processing 2D spots")
        table = ReflectionTable()
        coms, ids = [], []
        for i, imageno in enumerate(sorted(loop.centers_2d)):
            c = loop.centers_2d[imageno]
            if i > 0:
                table.generate_new_attributes()
            coms.append(c)
            ids.append(np.full(len(c), i, dtype=np.int64))
        flat = np.concatenate(coms) if coms else np.zeros((0, 3))
        table["xyzobs.px.value"] = flat
        table["id"] = np.concatenate(ids) if ids else np.zeros(0, dtype=np.int64)
        table.write("results_ffs.h5")
        print(f"Successfully wrote {len(flat)} 2D reflections to HDF5 file")
        print("2D spot analysis complete")
    tracing.record("ffs.epilogue", epilogue_t0)

    total_time = time.monotonic() - all_images_start
    completed, time_waiting = loop.completed, loop.time_waiting
    bytes_proc = width * height * reader.get_element_size() * completed
    gbps = bytes_proc / max(total_time, 1e-9) / 1e9
    print(
        f"\n{completed} images in {total_time:.2f} s ({gbps:.2f} GBps) "
        f"({completed / max(total_time, 1e-9):.1f} fps)"
    )
    if time_waiting < 10:
        print(f"Total time waiting for images to appear: {time_waiting * 1000:.0f} ms")
    else:
        print(f"Total time waiting for images to appear: {time_waiting:.2f} s")
    report = tracing.report(loop_t0, loop_t1, launches={
        name: fn.launches for name, fn in kernel_wrappers().items()})
    overflow = report["counters"]["fallback_batch_overflow"]
    if overflow:
        print(f"{overflow} frames past the batched per-frame capacity ran on the per-frame path")
    print(json.dumps({"ffs_trace": report}), flush=True)
    if trace is not None:
        spans = os.path.join(args.jax_profile, "spans.json")
        tracing.write_chrome(spans, trace)
        print(f"Spans written to {spans}")
    if pipe is not None:
        pipe.close()
    return 2 if loop.validate_failures else 0


def main() -> None:
    sys.exit(run(default_pixel_depth=16))


def main32() -> None:
    sys.exit(run(default_pixel_depth=32))


if __name__ == "__main__":
    sys.exit(run())
