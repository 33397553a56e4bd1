"""The spotfinder CLI's collection loop (``ffs_tpu_torch/pipeline/collection.py``)
and its three queue rules, on a fake reader and a fake processor.

The reader makes (4, 8) u16 frames whose pixels hold the image number plus
one, so that the processor can tell each frame, and a zero frame is a pad.
The processor records every dispatch and collect; nothing runs on a
device.  Per frame, no more than ``frames_in_flight(threads)`` frames are
dispatched and not yet collected, and the queue fills to that depth;
batched, one batch is in flight when the next is dispatched and the tail
batch is zero-padded to B; the decode queue hands frames to dispatch in
image order, and blocks on its head once more than ``threads`` frames wait.
A late reader (:class:`LateReader`) makes intake miss: before it sleeps on
the next image, every frame it holds is collected and its line written
(rule 4), and no partial batch is flushed for it.
The NeXus reader serves the reader pool beside the main thread's poll.
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from ffs_tpu_torch.ops.cc3d import FramePixels
from ffs_tpu_torch.pipeline import collection, spotfinder
from ffs_tpu_torch.spotfind import FrameResult, SpotfindConfig
from ffs_tpu_torch.utils import tracing

from .util import synthetic_rotation_stack, write_nexus

H, W = 4, 8


class FakeReader:
    """Every image is there at once.  ``delay(n)`` seconds of decode for
    image n; ``on_poll(n)`` runs as intake polls for it, ``on_decoded(n)``
    once it is decoded."""

    def __init__(self, delay=lambda n: 0.0, on_poll=lambda n: None, on_decoded=lambda n: None):
        self.delay, self.on_poll, self.on_decoded = delay, on_poll, on_decoded
        self.polled: list[int] = []

    def get_element_size(self):
        return 2

    def is_image_available(self, n):
        self.on_poll(n)
        self.polled.append(n)
        return True

    def get_image(self, n):
        time.sleep(self.delay(n))
        image = np.full((H, W), n + 1, dtype=np.uint16)
        self.on_decoded(n)
        return image


class LateReader(FakeReader):
    """Image n is there only at intake's ``misses(n) + 1``-th poll for it;
    ``on_miss(n, k)`` runs at its k-th missed poll, counted from 1.  The
    first miss comes before rule 4, every later one before a sleep."""

    def __init__(self, misses, on_miss=lambda n, k: None, **kw):
        super().__init__(**kw)
        self.misses, self.on_miss = misses, on_miss
        self.missed: dict[int, int] = {}

    def is_image_available(self, n):
        super().is_image_available(n)
        k = self.missed.get(n, 0)
        if k < self.misses(n):
            self.missed[n] = k + 1
            self.on_miss(n, k + 1)
            return False
        return True


class FakeProcessor:
    """Records ``(event, image numbers)`` for each dispatch and collect, and
    for each dispatch the dispatches not yet collected: ``before`` it (the
    one being dispatched not counted) and ``after`` it."""

    width, height, trusted_max = W, H, 65535.0

    def __init__(self, batch: bool = False):
        self.batch = batch
        self.config = SpotfindConfig()
        self.events: list[tuple[str, list[int]]] = []
        self.before: list[int] = []
        self.after: list[int] = []
        self.stacks: list[np.ndarray] = []

    def _outstanding(self) -> int:
        return sum(+1 if e.startswith("dispatch") else -1 for e, _ in self.events)

    def _dispatched(self, event: str, nums: list[int]) -> None:
        self.before.append(self._outstanding())
        self.events.append((event, nums))
        self.after.append(self._outstanding())

    def batch_supported(self):
        return self.batch

    def dispatch(self, image):
        num = int(image[0, 0]) - 1
        self._dispatched("dispatch", [num])
        return num

    def collect(self, image_number, device_result, want_com=False):
        assert device_result == image_number
        self.events.append(("collect", [image_number]))
        return _result(image_number)

    def dispatch_batch(self, images):
        self.stacks.append(images.copy())
        nums = [int(v) - 1 for v in images[:, 0, 0] if v]
        self._dispatched("dispatch_batch", nums)
        return nums

    def collect_batch(self, image_numbers, device_result, images=None, want_com=False):
        assert device_result == list(image_numbers)
        self.events.append(("collect_batch", list(image_numbers)))
        return [_result(n) for n in image_numbers]


def _result(n: int) -> FrameResult:
    one = np.array([n], dtype=np.int64)
    return FrameResult(image_number=n, n_strong_pixels=n, n_spots=0, n_spots_prefilter=0,
                       n_strong_pixels_filtered=0,
                       pixels=FramePixels(linear_index=one, intensity=one, root=one))


class FakeMerger:
    def __init__(self):
        self.pushed: list[int] = []

    def push_frame(self, pixels):
        self.pushed.append(int(pixels.linear_index[0]))


def _lines(pipe) -> list[int]:
    return [json.loads(line)["file-number"] for line in pipe.getvalue().splitlines()]


def _collect(reader, processor, n_images, *flags, rotation=False, pipe=None, merger=None):
    """Run the loop over ``n_images``; (its pipe lines' image numbers, the loop)."""
    tracing.start(False)
    args = spotfinder._build_parser("test").parse_args(["--sample", *flags])
    pipe = pipe or io.StringIO()
    loop = collection.Collection(args, reader, processor, np.ones((H, W), np.uint8),
                                 num_images=n_images, rotation=rotation, pipe=pipe,
                                 stop=threading.Event())
    loop.merger = merger or FakeMerger()
    try:
        loop.run()
    finally:
        loop.close()
    lines = _lines(pipe)
    assert loop.completed == len(lines)
    assert processor._outstanding() == 0  # everything dispatched was collected
    return lines, loop


def _polled_at_first_dispatch(reader, proc) -> int:
    """The last image intake had polled for when image 0 was dispatched."""
    polled = []
    dispatch = proc.dispatch

    def first(image):
        if not proc.events:
            polled.append(max(reader.polled))
        return dispatch(image)

    proc.dispatch = first
    return polled


@pytest.mark.parametrize("threads", [1, 2, 8])
def test_per_frame_keeps_frames_in_flight_to_the_rule(threads, capsys):
    n = 20
    depth = collection.frames_in_flight(threads)
    assert depth == max(2, min(threads, 8))
    proc = FakeProcessor()
    lines, loop = _collect(FakeReader(), proc, n, "--threads", str(threads), rotation=True)
    assert max(proc.after) == depth  # the queue fills to the rule, and no further
    assert lines == list(range(n))
    assert loop.merger.pushed == list(range(n))  # 3D pushes in acquisition order


def test_batched_keeps_one_batch_in_flight_and_pads_the_tail(capsys):
    n, b = 10, 4
    proc = FakeProcessor(batch=True)
    lines, _ = _collect(FakeReader(), proc, n, "--threads", "2", "--batch", str(b))
    assert proc.before == [0] + [collection.BATCHES_IN_FLIGHT] * 2
    assert [nums for e, nums in proc.events if e == "dispatch_batch"] == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    assert all(s.shape == (b, H, W) for s in proc.stacks)
    assert not proc.stacks[-1][2:].any()  # the tail's two pad frames are zeros
    assert lines == list(range(n))


@pytest.mark.parametrize("threads", [1, 4])
def test_decode_queue_dispatches_in_image_order(threads, capsys):
    """Later images decode faster than earlier ones, yet go to dispatch in
    image order; and while the head's decode holds, intake stops once more
    than ``threads`` images wait on the reader pool."""
    n = 12
    head_free = threading.Event()

    def delay(k):
        if k == 0:  # freed when intake polls past the rule, else after 1 s
            head_free.wait(timeout=1.0)
        return 0.002 * (n - k)

    reader = FakeReader(delay, on_poll=lambda k: k > threads and head_free.set())
    proc = FakeProcessor()
    polled = _polled_at_first_dispatch(reader, proc)
    lines, _ = _collect(reader, proc, n, "--threads", str(threads))
    assert [nums[0] for e, nums in proc.events if e == "dispatch"] == list(range(n))
    assert polled == [threads]  # images 0..threads waited, no more
    assert lines == list(range(n))


def test_decode_queue_hands_over_a_done_head_at_once(capsys):
    """A head whose decode is done goes to dispatch at the next intake,
    without waiting for ``threads`` more images to queue behind it."""
    threads, n = 4, 8
    head_done = threading.Event()

    def poll(k):
        if k == 1:  # image 0's decode is done, and its future marked so
            assert head_done.wait(timeout=30.0)
            time.sleep(0.2)

    reader = FakeReader(on_poll=poll, on_decoded=lambda k: k == 0 and head_done.set())
    proc = FakeProcessor()
    polled = _polled_at_first_dispatch(reader, proc)
    lines, _ = _collect(reader, proc, n, "--threads", str(threads))
    assert polled[0] <= 1 < threads
    assert lines == list(range(n))


def _collected(proc) -> list[int]:
    return [n for e, nums in proc.events if e.startswith("collect") for n in nums]


def _idle_drained() -> int:
    return tracing.report()["counters"]["idle_drain_frames"]


@pytest.mark.parametrize("threads", [1, 8])
def test_idle_drain_emits_every_frame_before_the_poll_sleeps(threads, capsys):
    """Rule 4, per frame: when image ``num`` is late, every image below it is
    collected, pushed and its line written before intake sleeps on it."""
    n, late = 20, (5, 10, 15)
    proc, pipe, merger = FakeProcessor(), io.StringIO(), FakeMerger()
    seen = {}

    def on_miss(k, miss):
        if miss == 2:  # rule 4 has run; the poll sleeps next
            seen[k] = (_collected(proc), _lines(pipe), list(merger.pushed))

    reader = LateReader(lambda k: 2 if k in late else 0, on_miss)
    lines, loop = _collect(reader, proc, n, "--threads", str(threads), rotation=True,
                           pipe=pipe, merger=merger)
    assert seen == {k: (list(range(k)),) * 3 for k in late}
    assert max(proc.after) <= collection.frames_in_flight(threads)
    assert lines == list(range(n))
    assert loop.merger.pushed == list(range(n))
    assert 0 < _idle_drained() <= 15


def test_idle_drain_collects_full_batches_and_flushes_no_partial_one(capsys):
    """Rule 4, batched: a full batch is collected before the poll sleeps; a
    partial one waits in the buffer, so the batches are those of a reader
    that is never late, and only the tail is padded."""
    n, b, late = 14, 4, (5, 8, 13)
    proc, pipe = FakeProcessor(batch=True), io.StringIO()
    seen = {}

    def on_miss(k, miss):
        if miss == 2:
            seen[k] = (_collected(proc), _lines(pipe))

    reader = LateReader(lambda k: 2 if k in late else 0, on_miss)
    lines, _ = _collect(reader, proc, n, "--threads", "2", "--batch", str(b), pipe=pipe)
    assert seen == {5: (list(range(4)),) * 2, 8: (list(range(8)),) * 2,
                    13: (list(range(12)),) * 2}
    assert [nums for e, nums in proc.events if e == "dispatch_batch"] == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11], [12, 13]]
    assert all(s.shape == (b, H, W) for s in proc.stacks)
    assert all(s.all() for s in proc.stacks[:-1])  # no pad before the tail
    assert not proc.stacks[-1][2:].any()
    assert lines == list(range(n))
    assert _idle_drained() == 12  # the three full batches before the misses


@pytest.mark.parametrize("late", [False, True])
def test_idle_drain_frames_counts_the_frames_rule_4_emits(late, capsys):
    """Every image after the first is late by one poll: each frame's line is
    written in the drain before the next image; a reader that is never
    late never drains."""
    n = 12
    reader = LateReader(lambda k: int(late and k > 0))
    lines, _ = _collect(reader, FakeProcessor(), n, "--threads", "4")
    assert lines == list(range(n))
    assert _idle_drained() == (n - 1 if late else 0)


def test_time_waiting_leaves_the_idle_drain_out(capsys):
    """A collect that takes 0.2 s runs inside the drain, not inside the
    wait: the loop's waiting time stays below one collect."""
    n, pause = 3, 0.2

    class SlowCollect(FakeProcessor):
        def collect(self, image_number, device_result, want_com=False):
            time.sleep(pause)
            return super().collect(image_number, device_result, want_com)

    reader = LateReader(lambda k: int(k > 0))
    lines, loop = _collect(reader, SlowCollect(), n, "--threads", "2")
    assert lines == list(range(n))
    assert _idle_drained() == n - 1  # two collects, 0.4 s, ran in the drain
    assert loop.time_waiting < pause


def test_nexus_reader_serves_reader_threads_beside_the_poll(tmp_path):
    """Reader threads read and decode chunks while the main thread polls
    (a SWMR refresh): more threads than cores, a switch every microsecond,
    every frame read back whole."""
    from ffs_tpu_torch.io.nexus import NexusReader

    stack, mask = synthetic_rotation_stack()
    path = tmp_path / "rot.nxs"
    write_nexus(path, stack, oscillation=(0.0, 0.1), mask=mask, compression="bshuf")
    reader = NexusReader(str(path))
    errors = []

    def read(k):
        try:
            for r in range(20):
                i = (k + r) % len(stack)
                assert reader.is_image_available(i)
                np.testing.assert_array_equal(reader.get_image(i), stack[i])
                assert reader.get_image_planes(i) is not None
        except Exception as e:  # noqa: BLE001  (reported below, by thread)
            errors.append((k, repr(e)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=read, args=(k,))
                   for k in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        reader.close()
    assert not any(t.is_alive() for t in threads)
    assert errors == []
