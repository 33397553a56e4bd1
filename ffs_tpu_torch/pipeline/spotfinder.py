"""spotfinder CLI on PyTorch — per-image analysis executable.

Counterpart of :mod:`ffs_tpu.pipeline.spotfinder` with the same argument
surface, JSON-over-pipe protocol, scraped log lines (``Thread .. finished
image .. with .. strong pixels``, ``Calculated N spots``, ``Filtered N spots
with size < K pixels``), exit-code-32 bit-depth renegotiation, ``--validate``,
``--profile``, streaming 3D merge and ``results_ffs.h5``; ``--batch B``
runs frames through the batched path and ``--decode-backend device`` ships
the LZ4-decoded bitshuffle planes to the card, which decodes them there
(both need the kernel path: ``--precision f32`` on a CUDA device);
``--jax-profile DIR`` writes a ``torch.profiler`` trace of the collection
loop and the loop's spans (:mod:`..utils.tracing`); every run ends with
one ``{"ffs_trace": ...}`` line of counters.  The reader, algorithm-name
and validation helpers are copies of the JAX CLI's (they touch no
framework).

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
import time
from collections import deque

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


def validate_strong_pixels(
    image_host: np.ndarray,
    mask: np.ndarray,
    trusted_max: float,
    algorithm: str,
    linear_index: np.ndarray,
    height: int,
    width: int,
    image_num: int,
) -> tuple[bool, str]:
    """Pixel-exact validation of a frame's strong-pixel set against the
    standalone DIALS-equivalent oracle (:mod:`..ops.reference`).

    Matches the reference's per-pixel compare_results scan (reference:
    spotfinder/spotfinder.cc:1011-1053): equal counts with swapped pixels is
    a MISMATCH, and the first differing coordinate is reported.
    """
    from ..ops import reference as ref

    if algorithm == "dispersion":
        want = ref.dispersion(image_host, mask, trusted_max)
    else:
        want = ref.dispersion_extended(image_host, mask, trusted_max)
    want = np.asarray(want, dtype=bool)
    got = np.zeros((height, width), dtype=bool)
    got.reshape(-1)[np.asarray(linear_index)] = True
    got_n = int(got.sum())
    if np.array_equal(got, want):
        return True, (
            f"Thread  0, Image {image_num:4d}: Compared: Match {got_n} px"
        )
    diff = got ^ want
    my, mx = np.unravel_index(int(np.argmax(diff)), diff.shape)
    return False, (
        f"Thread  0, Image {image_num:4d}: Compared: "
        f"Mismatch ({got_n} px from kernel); first differing pixel at "
        f"x={mx} y={my} (kernel={bool(got[my, mx])}, dials={bool(want[my, mx])})"
    )


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
        "--compact-backend",
        choices=["device", "host"],
        default=_env_choice("FFS_SPOTFIND_COMPACT", "device", ("device", "host")),
        help="Where strong-pixel compaction runs.  'host' ends the device's"
        " job at the packed strong words and expands them on the CPU against"
        " the decoded frame copy (requires --precision f32 on a GPU; with"
        " --precision f64 the run stops with an error: the option is not"
        " ignored there).  Env default: FFS_SPOTFIND_COMPACT.",
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
        " whose float64 threshold ran as the float64 walker), and the"
        " kernels' launches.",
    )
    return p


def run(argv=None, default_pixel_depth: int = 16) -> int:
    t_entry = time.time_ns()
    from ..models.geometry import Scan, simple_panel
    from ..models.reflection_table import ReflectionTable
    from ..ops import cc3d
    from ..utils.cli import apply_verbosity, expand_common_args

    from .. import __version__
    from ..bench import kernel_wrappers
    from ..io import compression
    from ..spotfind import SpotfindConfig, SpotfindProcessor
    from ..utils import torchinit, tracing

    torchinit.setup()
    print(f"Spotfinder version: {__version__}")
    args = _build_parser(__version__).parse_args(expand_common_args(argv))
    apply_verbosity(args)
    tracing.start(bool(args.jax_profile))

    # Cooperative SIGINT cancellation (reference: spotfinder.cc:43-54,603):
    # the first Ctrl-C stops image intake so the epilogue still runs; a
    # second Ctrl-C exits immediately.
    stop_requested = False

    def _sigint(_signum, _frame):
        nonlocal stop_requested
        if stop_requested:
            print("Second interrupt received; exiting immediately", flush=True)
            os._exit(130)
        stop_requested = True
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
        compact_backend=args.compact_backend,
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

    want_com = (not rotation) and (args.save_h5 or args.output_for_index)

    rotation_slices: dict[int, cc3d.FramePixels] = {}
    reflection_centers_2d: dict[int, np.ndarray] = {}
    # streaming 3D merge: frames feed the label-equivalence state in
    # acquisition order as they complete; keep_pixels retains pixel
    # membership for the sigma_b/sigma_m variance stage
    stream_merger = cc3d.StreamingMerger3D(width, keep_pixels=True)
    next_stream_push = args.start_index

    def _stream_ready_frames():
        nonlocal next_stream_push
        while next_stream_push in rotation_slices:
            stream_merger.push_frame(rotation_slices.pop(next_stream_push))
            next_stream_push += 1

    all_images_start = time.monotonic()
    time_waiting = 0.0
    completed = 0

    # dispatch up to `depth` frames ahead of collection so host decode and
    # the device step overlap
    depth = max(2, min(args.threads, 8))
    inflight: deque = deque()

    validate_failures = 0

    def _emit(image_num: int, result, image_host):
        nonlocal completed
        timings = None
        if isinstance(result, tuple) and len(result) == 3 and result[0] == "profiled":
            _, res, timings = result
        elif isinstance(result, tuple) and len(result) == 2 and result[0] == "collected":
            res = result[1]  # batched mode: already a FrameResult
        else:
            res = processor.collect(image_num, result, want_com=want_com)
        if rotation:
            rotation_slices[image_num] = res.pixels
            with tracing.span("ffs.push3d", frame=image_num):
                _stream_ready_frames()
        elif want_com:
            reflection_centers_2d[image_num] = res.centers_of_mass
        with tracing.span("ffs.emit", frame=image_num):
            _emit_lines(image_num, res, image_host, timings)
        completed += 1

    def _emit_lines(image_num: int, res, image_host, timings):
        """The frame's pipe line, log lines and --validate/--writeout."""
        nonlocal validate_failures
        n_strong = res.n_strong_pixels
        n_boxes = res.n_spots
        # per-image component log lines (reference: connected_components.cc
        # generate_boxes -> "Extracted"/"Removed", scraped by the tests)
        n_extracted = res.n_spots_prefilter
        print(f"Extracted {n_extracted} spots")
        if args.min_spot_size > 0 and n_extracted - n_boxes > 0:
            print(
                f"Removed {n_extracted - n_boxes} spots with size < "
                f"{args.min_spot_size} pixels"
            )

        if args.writeout:
            with open(f"pixels_{image_num:05d}.txt", "w") as out:
                lin = res.pixels.linear_index
                for k in range(len(lin)):
                    out.write(f"{lin[k] % width:4d}, {lin[k] // width:4d}\n")
            from ..utils.writeout import write_image_png

            strong_img = np.zeros((height, width), dtype=bool)
            strong_img.reshape(-1)[res.pixels.linear_index] = True
            write_image_png(f"image_{image_num:05d}.png", image_host, strong_img)

        if pipe is not None:
            payload = {
                "num_strong_pixels": int(n_strong),
                "file": args.file,
                "file-number": int(image_num),
                "n_spots_total": int(n_boxes),
            }
            if args.output_for_index:
                payload["spot_centers"] = [float(v) for v in res.centers_of_mass.reshape(-1)]
            pipe.write(json.dumps(payload) + "\n")
            pipe.flush()
            tracing.count("lines_out")

        if args.validate:
            ok_match, message = validate_strong_pixels(
                image_host,
                np.asarray(mask),
                trusted_max,
                algo.name,
                res.pixels.linear_index,
                height,
                width,
                image_num,
            )
            if not ok_match:
                validate_failures += 1
            print(message)
        else:
            print(
                f"Thread  0 finished image {image_num:4d} with {n_strong:5d} "
                f"strong pixels, {n_boxes:4d} filtered reflections "
                f"({res.n_strong_pixels_filtered} pixels)"
            )
        if timings is not None:
            # per-image stage breakdown (reference: spotfinder.cc:1054-1087)
            for stage_name, ms in timings.items():
                print(f"    {stage_name:>12s}: {ms:7.1f} ms")

    # reader-thread pool: HDF5 chunk reads + bitshuffle-LZ4 decode overlap
    # across frames (the native codecs release the GIL); decoded frames
    # feed the dispatch deque in order
    executor = None
    decode_q: deque = deque()
    if args.threads > 1:
        from concurrent.futures import ThreadPoolExecutor

        executor = ThreadPoolExecutor(max_workers=args.threads)

    # batched collection (--batch B): frames buffer into batches of B and
    # run through the batched path
    batch_n = max(1, args.batch)
    use_batch = batch_n > 1 and not args.profile and processor.batch_supported()
    if batch_n > 1 and not use_batch:
        print(
            "Batched mode unavailable "
            "(requires the kernel path: CUDA + f32); "
            "falling back to per-frame processing"
        )
    # device-side bitshuffle decode (--decode-backend device): the reader
    # threads stop at the LZ4 stage; the planes upload and become frames on
    # the card inside the batch (ops/bitshuffle_device.py)
    decode_device = (
        args.decode_backend == "device" and use_batch and hasattr(reader, "get_image_planes")
    )
    if args.decode_backend == "device" and not decode_device:
        print(
            "Device decode unavailable (requires --batch on the kernel "
            "path and a bitshuffle-LZ4 reader); "
            "falling back to host decode"
        )
    pixel_dtype = np.uint16 if bytes_per_pixel == 2 else np.uint32

    def _fetch(num):
        """Reader-thread payload: LZ4-only planes when device decode is on
        and the frame supports it, the decoded frame otherwise."""
        with tracing.span("ffs.fetch", frame=num, annotate=False):
            if decode_device:
                planes = reader.get_image_planes(num)
                if planes is not None:
                    return ("planes", planes)
            vector = compression.vector_decodes()
            image = reader.get_image(num)
            if compression.vector_decodes() > vector:
                tracing.count("host_decode_vector")
            return ("frame", image)

    class _LazyFrames:
        """Host frames decoded on demand (the batched overflow fallback and
        --validate/--writeout are the only consumers in planes mode)."""

        def __init__(self, nums):
            self._nums = nums
            self._cache: dict = {}

        def __getitem__(self, b):
            if b not in self._cache:
                self._cache[b] = reader.get_image(self._nums[b])
            return self._cache[b]

    batch_buf: list = []  # [(image_num, (tag, payload), stamp of its append)]
    need_host_frames = bool(args.validate or args.writeout)

    def _emit_next():
        kind, key, result, host, queued = inflight.popleft()
        nums = key if kind == "batch" else [key]
        tracing.record("ffs.inflight", queued, nums[0], len(nums), tracing.QUEUE)
        if kind == "batch":
            ress = processor.collect_batch(nums, result, images=host, want_com=want_com)
            lazy = isinstance(host, _LazyFrames)
            # one span for the batch's lines (its 3D pushes are recorded within)
            with tracing.span("ffs.emit", frame=nums[0], frames=len(nums)):
                for b, (num, res) in enumerate(zip(nums, ress)):
                    _emit(num, ("collected", res),
                          None if (lazy and not need_host_frames) else host[b])
        else:
            _emit(key, result, host)
        with tracing.span("ffs.release", frame=nums[0], frames=len(nums)):
            del result, host  # the frames on the host and the device step's outputs

    def _flush_batch():
        if not batch_buf:
            return
        nums = [n for n, _, _ in batch_buf]
        payloads = [p for _, p, _ in batch_buf]
        for num, _, appended in batch_buf:
            tracing.record("ffs.batch_fill", appended, num, 1, tracing.QUEUE)
        tracing.count("batches")
        tracing.at(nums[0], len(nums))
        if all(tag == "planes" for tag, _ in payloads):
            with tracing.span("ffs.stack"):
                pls = [a for _, a in payloads]
                stack = np.stack(pls + [np.zeros_like(pls[0])] * (batch_n - len(pls)))
            dev = processor.dispatch_batch_planes(stack, dtype=pixel_dtype)
            tracing.count("device_decode_frames", len(nums))
            imgs = _LazyFrames(nums)
        else:
            # mixed batch (a frame fell back mid-stream): decode any planes
            # on the host and take the frame path
            with tracing.span("ffs.stack"):
                from ..ops.bitshuffle_device import planes_to_frame_host

                if decode_device:  # every frame of it was decoded on the host
                    tracing.count("fallback_host_decode", len(payloads))
                frames = [
                    a
                    if tag == "frame"
                    else planes_to_frame_host(a, height * width, bytes_per_pixel)
                    .view(pixel_dtype)
                    .reshape(height, width)
                    for tag, a in payloads
                ]
                stack = np.stack(frames + [np.zeros_like(frames[0])] * (batch_n - len(frames)))
            dev = processor.dispatch_batch(stack)
            imgs = frames
        inflight.append(("batch", nums, dev, imgs, tracing.stamp()))
        with tracing.span("ffs.release", frame=nums[0], frames=len(nums)):
            del stack  # copied to the device: the batch on the host can go
            batch_buf.clear()
        while len(inflight) >= 2:  # keep one batch in flight
            _emit_next()

    def _dispatch_image(num, payload):
        tag, image = payload
        if use_batch:
            batch_buf.append((num, (tag, image), tracing.stamp()))
            if len(batch_buf) == batch_n:
                _flush_batch()
            return
        tracing.at(num)
        if args.profile:
            res, timings = processor.process_frame_profiled(num, image, want_com=want_com)
            inflight.append(("frame", num, ("profiled", res, timings), image, tracing.stamp()))
        else:
            inflight.append(("frame", num, processor.dispatch(image), image, tracing.stamp()))
        if len(inflight) >= depth:
            _emit_next()

    def _drain_decoded(block: bool):
        while decode_q and (block or decode_q[0][1].done() or len(decode_q) > args.threads):
            num, fut = decode_q.popleft()
            with tracing.span("ffs.decode_wait", frame=num):
                payload = fut.result()
            _dispatch_image(num, payload)

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
        last_image_received = time.monotonic()
        for image_num in range(num_images):
            if stop_requested:
                print("Stopping image intake on interrupt")
                break
            offset_num = image_num + args.start_index
            appeared = True
            with tracing.span("ffs.reader_wait", frame=offset_num):
                wait_start = time.monotonic()
                while not reader.is_image_available(offset_num):
                    if stop_requested:
                        appeared = False
                        break
                    if time.monotonic() - last_image_received > args.timeout:
                        print(f"Timeout waiting for image {offset_num}")
                        appeared = False
                        break
                    time.sleep(0.1)
                if appeared:
                    last_image_received = time.monotonic()
                    time_waiting += last_image_received - wait_start
            if not appeared:
                break  # interrupt or timeout
            tracing.count("frames_in")
            if executor is not None:
                with tracing.span("ffs.submit", frame=offset_num):
                    decode_q.append((offset_num, executor.submit(_fetch, offset_num)))
                _drain_decoded(block=False)
            else:
                with tracing.span("ffs.decode_wait", frame=offset_num):
                    payload = _fetch(offset_num)
                _dispatch_image(offset_num, payload)

        if executor is not None:
            _drain_decoded(block=True)
        if use_batch:
            _flush_batch()  # partial tail batch (zero-padded to B)
        while inflight:
            _emit_next()
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
    if executor is not None:
        executor.shutdown(wait=True)  # its threads are idle: every image was taken

    epilogue_t0 = tracing.stamp()

    # ----- epilogues (reference: spotfinder.cc:1099-1305) -------------------
    if rotation:
        print("Processing 3D spots")
        # frames still buffered (SIGINT / out-of-order tail) stream in
        # acquisition order
        for k in sorted(rotation_slices):
            stream_merger.push_frame(rotation_slices.pop(k))
        spots = stream_merger.finalize()
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
        for i, imageno in enumerate(sorted(reflection_centers_2d)):
            c = reflection_centers_2d[imageno]
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
    return 2 if validate_failures else 0


def main() -> None:
    sys.exit(run(default_pixel_depth=16))


def main32() -> None:
    sys.exit(run(default_pixel_depth=32))


if __name__ == "__main__":
    sys.exit(run())
