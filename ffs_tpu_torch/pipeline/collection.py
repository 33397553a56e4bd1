"""The spotfinder CLI's collection loop.

:func:`ffs_tpu_torch.pipeline.spotfinder.run` parses the arguments, builds
the reader and the processor, then builds a :class:`Collection`, runs it,
and writes the epilogue from what it holds afterwards.  The loop takes
images in order on the main thread: it polls the reader until the next
image is there (``ffs.reader_wait``), hands it to a pool of ``--threads``
reader threads that read and decode it (``ffs.submit``; ``ffs.fetch`` on
the reader thread), and dispatches the decoded frames to the processor,
one by one or in batches of ``--batch`` B (``ffs.stack``).  A collected
frame is emitted: its 3D push, its pipe line, its log lines, ``--validate``
and ``--writeout``.

Four rules bound the queues between those stages:

1. **Frames in flight** (per frame): at most :func:`frames_in_flight`,
   ``max(2, min(threads, 8))``, frames are dispatched and not yet
   collected.  The dispatch that fills the queue collects and emits its
   head, so the host's decode of the next frames overlaps the device step.
2. **One batch in flight** (``--batch``): :data:`BATCHES_IN_FLIGHT`.  Once
   a batch is dispatched, the batch before it is collected and emitted.
3. **The decode queue**: its head frame goes to dispatch when its reader
   thread is done with it, or when more than ``threads`` frames wait, and
   then the main thread blocks on it (``ffs.decode_wait``); see
   :meth:`Collection._decode_head_due`.  When intake ends, the queue
   drains in order.
4. **The idle drain**: when intake finds the next image not there yet,
   the main thread has nothing else to do, so before it polls on it
   dispatches every frame in the decode queue (blocking on each) and
   emits every frame in flight (:meth:`Collection._drain_idle`).  A live
   frame's line then waits for its own work, not for later frames to
   arrive; a partial batch stays in the buffer.  While the next image is
   there, rule 4 never runs, and rules 1-3 alone order the loop.

Every queue is first in, first out, so lines come out in image order and
the 3D merge takes frames in acquisition order.  A partial tail batch is
zero-padded to B.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np

from ..io import compression
from ..ops import cc3d
from ..utils import tracing

# rule 2: batches dispatched and not yet collected when the next is dispatched
BATCHES_IN_FLIGHT = 1


def frames_in_flight(threads: int) -> int:
    """Rule 1: how many frames may be dispatched and not yet collected."""
    return max(2, min(threads, 8))


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


class _Planes(NamedTuple):
    """A reader thread's payload under device decode: the frame's
    LZ4-decoded bitshuffle planes (a decoded frame is a bare array)."""

    data: np.ndarray


class _LazyFrames:
    """Host frames decoded on demand (the batched overflow fallback and
    --validate/--writeout are the only consumers in planes mode)."""

    def __init__(self, reader, nums):
        self._reader = reader
        self._nums = nums
        self._cache: dict = {}

    def __getitem__(self, b):
        if b not in self._cache:
            self._cache[b] = self._reader.get_image(self._nums[b])
        return self._cache[b]


@dataclass
class InFlight:
    """A frame or a batch between its dispatch and its lines."""

    nums: list[int]  # its image numbers
    batch: bool
    host: Any  # the host frame; for a batch, its frames by position
    queued: int  # tracing.stamp() at the end of its dispatch
    device: Any = None  # what dispatch / dispatch_batch(_planes) returned
    profiled: Optional[tuple] = None  # --profile: (FrameResult, timings)

    def collect(self, processor, want_com: bool) -> list:
        """Its FrameResults, in image order.  The processor's methods are
        looked up here, at call time: a harness may patch them on the class."""
        if self.profiled is not None:
            return [self.profiled[0]]
        if self.batch:
            return processor.collect_batch(
                self.nums, self.device, images=self.host, want_com=want_com
            )
        return [processor.collect(self.nums[0], self.device, want_com=want_com)]


class Collection:
    """One collection's loop: intake, the reader pool and its decode queue,
    the batch buffer, the in-flight queue and emission.

    ``args`` is the CLI's parsed arguments; ``stop`` is set by the SIGINT
    handler to end intake.  After :meth:`run` the epilogue reads
    :attr:`merger` and :attr:`rotation_slices` (rotation), :attr:`centers_2d`
    (stills), :attr:`completed`, :attr:`time_waiting` and
    :attr:`validate_failures`; :meth:`close` then stops the reader pool.
    """

    def __init__(self, args, reader, processor, mask, *, num_images: int, rotation: bool,
                 pipe=None, stop: threading.Event):
        self.args = args
        self.reader = reader
        self.processor = processor
        self.mask = np.asarray(mask)
        self.num_images = num_images
        self.rotation = rotation
        self.pipe = pipe
        self.stop = stop
        self.width, self.height = processor.width, processor.height
        self.bytes_per_pixel = reader.get_element_size()
        self.pixel_dtype = np.uint16 if self.bytes_per_pixel == 2 else np.uint32
        self.want_com = (not rotation) and (args.save_h5 or args.output_for_index)
        self.need_host_frames = bool(args.validate or args.writeout)

        # what the epilogue reads
        self.rotation_slices: dict[int, cc3d.FramePixels] = {}
        self.centers_2d: dict[int, np.ndarray] = {}
        # streaming 3D merge: frames feed the label-equivalence state in
        # acquisition order as they complete; keep_pixels retains pixel
        # membership for the sigma_b/sigma_m variance stage
        self.merger = cc3d.StreamingMerger3D(self.width, keep_pixels=True)
        self.next_push = args.start_index
        self.completed = 0
        self.time_waiting = 0.0
        self.validate_failures = 0

        self.depth = frames_in_flight(args.threads)
        self.inflight: deque[InFlight] = deque()
        # reader-thread pool: HDF5 chunk reads + bitshuffle-LZ4 decode overlap
        # across frames (the native codecs release the GIL); decoded frames
        # feed the dispatch in order
        self.pool = ThreadPoolExecutor(max_workers=args.threads)
        self.decode_q: deque = deque()  # (image number, future of its payload)

        # batched collection (--batch B): frames buffer into batches of B and
        # run through the batched path
        self.batch_n = max(1, args.batch)
        self.use_batch = self.batch_n > 1 and not args.profile and processor.batch_supported()
        if self.batch_n > 1 and not self.use_batch:
            print(
                "Batched mode unavailable "
                "(requires the kernel path: CUDA + f32); "
                "falling back to per-frame processing"
            )
        # device-side bitshuffle decode (--decode-backend device): the reader
        # threads stop at the LZ4 stage; the planes upload and become frames on
        # the card inside the batch (ops/bitshuffle_device.py)
        self.decode_device = (
            args.decode_backend == "device" and self.use_batch
            and hasattr(reader, "get_image_planes")
        )
        if args.decode_backend == "device" and not self.decode_device:
            print(
                "Device decode unavailable (requires --batch on the kernel "
                "path and a bitshuffle-LZ4 reader); "
                "falling back to host decode"
            )
        self.batch_buf: list = []  # [(image_num, payload, stamp of its append)]

    # --- intake -------------------------------------------------------------

    def run(self) -> None:
        """Take images in until the last, an interrupt or a timeout, then
        drain every queue in order."""
        self._last_received = time.monotonic()
        for image_num in range(self.num_images):
            if self.stop.is_set():
                print("Stopping image intake on interrupt")
                break
            num = image_num + self.args.start_index
            if not self._wait_for(num):
                break  # interrupt or timeout
            tracing.count("frames_in")
            with tracing.span("ffs.submit", frame=num):
                self.decode_q.append((num, self.pool.submit(self._fetch, num)))
            self._drain_decoded(block=False)

        self._drain_decoded(block=True)
        if self.use_batch:
            self._flush_batch()  # partial tail batch (zero-padded to B)
        while self.inflight:
            self._emit_next()

    def close(self) -> None:
        self.pool.shutdown(wait=True)  # its threads are idle: every image was taken

    def _wait_for(self, num: int) -> bool:
        """The availability poll: True once image ``num`` is there; False on
        an interrupt, or when no image has come for ``--timeout`` seconds.
        When the first check misses, rule 4 runs before the poll goes on;
        ``ffs.reader_wait`` and :attr:`time_waiting` leave its work out."""
        with tracing.span("ffs.reader_wait", frame=num):
            wait_start = time.monotonic()
            there = self.reader.is_image_available(num)
            self.time_waiting += time.monotonic() - wait_start
        if not there:
            self._drain_idle()
            with tracing.span("ffs.reader_wait", frame=num):
                wait_start = time.monotonic()
                while not self.reader.is_image_available(num):
                    if self.stop.is_set():
                        return False
                    if time.monotonic() - self._last_received > self.args.timeout:
                        print(f"Timeout waiting for image {num}")
                        return False
                    time.sleep(0.1)
                self.time_waiting += time.monotonic() - wait_start
        self._last_received = time.monotonic()
        return True

    def _drain_idle(self) -> None:
        """Rule 4: the next image is not there yet, so dispatch every
        decoded frame and emit every frame in flight, in order.  A partial
        batch stays in the buffer."""
        completed = self.completed
        self._drain_decoded(block=True)
        while self.inflight:
            self._emit_next()
        tracing.count("idle_drain_frames", self.completed - completed)

    # --- the reader pool ----------------------------------------------------

    def _fetch(self, num):
        """Reader-thread payload: LZ4-only planes when device decode is on
        and the frame supports it, the decoded frame otherwise."""
        with tracing.span("ffs.fetch", frame=num, annotate=False):
            if self.decode_device:
                planes = self.reader.get_image_planes(num)
                if planes is not None:
                    return _Planes(planes)
            vector = compression.vector_decodes()
            image = self.reader.get_image(num)
            if compression.vector_decodes() > vector:
                tracing.count("host_decode_vector")
            return image

    def _decode_head_due(self, block: bool) -> bool:
        """Rule 3: the decode queue's head goes to dispatch now (when
        ``block``, at the end of intake, it always does)."""
        q = self.decode_q
        return bool(q) and (block or q[0][1].done() or len(q) > self.args.threads)

    def _drain_decoded(self, block: bool) -> None:
        while self._decode_head_due(block):
            num, fut = self.decode_q.popleft()
            with tracing.span("ffs.decode_wait", frame=num):
                payload = fut.result()
            self._dispatch_image(num, payload)

    # --- dispatch -----------------------------------------------------------

    def _dispatch_image(self, num: int, payload) -> None:
        if self.use_batch:
            self.batch_buf.append((num, payload, tracing.stamp()))
            if len(self.batch_buf) == self.batch_n:
                self._flush_batch()
            return
        tracing.at(num)
        if self.args.profile:
            done = self.processor.process_frame_profiled(num, payload, want_com=self.want_com)
            entry = InFlight([num], False, payload, tracing.stamp(), profiled=done)
        else:
            dev = self.processor.dispatch(payload)
            entry = InFlight([num], False, payload, tracing.stamp(), device=dev)
        self.inflight.append(entry)
        if len(self.inflight) >= self.depth:  # rule 1
            self._emit_next()

    def _flush_batch(self) -> None:
        batch_buf, batch_n = self.batch_buf, self.batch_n
        if not batch_buf:
            return
        nums = [n for n, _, _ in batch_buf]
        payloads = [p for _, p, _ in batch_buf]
        for num, _, appended in batch_buf:
            tracing.record("ffs.batch_fill", appended, num, 1, tracing.QUEUE)
        tracing.count("batches")
        tracing.at(nums[0], len(nums))
        if all(isinstance(p, _Planes) for p in payloads):
            with tracing.span("ffs.stack"):
                pls = [p.data for p in payloads]
                stack = np.stack(pls + [np.zeros_like(pls[0])] * (batch_n - len(pls)))
            dev = self.processor.dispatch_batch_planes(stack, dtype=self.pixel_dtype)
            tracing.count("device_decode_frames", len(nums))
            imgs = _LazyFrames(self.reader, nums)
        else:
            # mixed batch (a frame fell back mid-stream): decode any planes
            # on the host and take the frame path
            with tracing.span("ffs.stack"):
                from ..ops.bitshuffle_device import planes_to_frame_host

                if self.decode_device:  # every frame of it was decoded on the host
                    tracing.count("fallback_host_decode", len(payloads))
                frames = [
                    planes_to_frame_host(p.data, self.height * self.width, self.bytes_per_pixel)
                    .view(self.pixel_dtype)
                    .reshape(self.height, self.width)
                    if isinstance(p, _Planes)
                    else p
                    for p in payloads
                ]
                stack = np.stack(frames + [np.zeros_like(frames[0])] * (batch_n - len(frames)))
            dev = self.processor.dispatch_batch(stack)
            imgs = frames
        self.inflight.append(InFlight(nums, True, imgs, tracing.stamp(), device=dev))
        with tracing.span("ffs.release", frame=nums[0], frames=len(nums)):
            del stack  # copied to the device: the batch on the host can go
            batch_buf.clear()
        while len(self.inflight) > BATCHES_IN_FLIGHT:  # rule 2
            self._emit_next()

    # --- emission -----------------------------------------------------------

    def _emit_next(self) -> None:
        entry = self.inflight.popleft()
        nums = entry.nums
        tracing.record("ffs.inflight", entry.queued, nums[0], len(nums), tracing.QUEUE)
        results = entry.collect(self.processor, self.want_com)
        if entry.batch:
            lazy = isinstance(entry.host, _LazyFrames)
            # one span for the batch's lines (its 3D pushes are recorded within)
            with tracing.span("ffs.emit", frame=nums[0], frames=len(nums)):
                for b, res in enumerate(results):
                    self._emit(res, None if (lazy and not self.need_host_frames)
                               else entry.host[b])
        else:
            self._emit(results[0], entry.host,
                       entry.profiled[1] if entry.profiled is not None else None)
        with tracing.span("ffs.release", frame=nums[0], frames=len(nums)):
            del entry  # the frames on the host and the device step's outputs

    def _push_ready_frames(self) -> None:
        while self.next_push in self.rotation_slices:
            self.merger.push_frame(self.rotation_slices.pop(self.next_push))
            self.next_push += 1

    def _emit(self, res, image_host, timings: Optional[dict] = None) -> None:
        """One frame's 3D push or 2D centres, then its lines."""
        num = res.image_number
        if self.rotation:
            self.rotation_slices[num] = res.pixels
            with tracing.span("ffs.push3d", frame=num):
                self._push_ready_frames()
        elif self.want_com:
            self.centers_2d[num] = res.centers_of_mass
        with tracing.span("ffs.emit", frame=num):
            self._emit_lines(res, image_host, timings)
        self.completed += 1

    def _emit_lines(self, res, image_host, timings: Optional[dict]) -> None:
        """The frame's pipe line, log lines and --validate/--writeout."""
        args, width, height = self.args, self.width, self.height
        image_num = res.image_number
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

        if self.pipe is not None:
            payload = {
                "num_strong_pixels": int(n_strong),
                "file": args.file,
                "file-number": int(image_num),
                "n_spots_total": int(n_boxes),
            }
            if args.output_for_index:
                payload["spot_centers"] = [float(v) for v in res.centers_of_mass.reshape(-1)]
            self.pipe.write(json.dumps(payload) + "\n")
            self.pipe.flush()
            tracing.count("lines_out")

        if args.validate:
            ok_match, message = validate_strong_pixels(
                image_host,
                self.mask,
                self.processor.trusted_max,
                self.processor.config.algorithm,
                res.pixels.linear_index,
                height,
                width,
                image_num,
            )
            if not ok_match:
                self.validate_failures += 1
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
