"""Per-image-analysis service on PyTorch.

Counterpart of :mod:`ffs_tpu.service.pia` (reference GPUPerImageAnalysis
zocalo service, src/ffs/service.py:288-520): consumes PiaRequests from a
message queue, launches the port's spotfinder (``spotfinder_torch``) per
collection with a JSON-over-pipe results channel, 1-bases frame numbers,
indexes the per-image spot centres with the port's SSX indexer when the
request carries a unit cell and a wavelength
(:func:`.pipe_index.index_pipe_payload`), forwards results to the
``result`` channel, and relaunches ``spotfinder32_torch`` when the
spotfinder exits with code 32.

Transport is pluggable: with ``zocalo``/``workflows`` installed the service
registers as ``TorchPerImageAnalysis`` (the ``workflows.services`` entry
point); without them, ``PiaService`` runs against any object satisfying the
tiny ``RecipeWrapperLike`` protocol, which is how the tests drive it
in-process.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time
from datetime import datetime
from pathlib import Path
from typing import Optional

from pydantic import BaseModel, ValidationError, field_validator

from .detectors import DetectorGeometry
from .pipe_index import index_pipe_payload

logger = logging.getLogger("ffs_tpu_torch.service")

DEFAULT_QUEUE_NAME = os.getenv("FFS_QUEUE", "per_image_analysis.gpu")


class PiaRequest(BaseModel):
    """Per-image-analysis request payload (reference: service.py:35-64)."""

    dcid: int
    dcgid: int
    filename: Path
    message_index: int
    number_of_frames: int
    start_frame_index: int
    startTime: Optional[datetime] = None
    wavelength: float | None = None
    xBeam: float
    yBeam: float
    detector_distance: float
    d_min: float | None = None
    d_max: float | None = None
    unit_cell: tuple[float, float, float, float, float, float] | None = None
    detector: str = "Eiger16M"

    @field_validator("unit_cell", mode="before")
    @classmethod
    def check_unit_cell(cls, v):
        if not v:
            return None
        orig = v
        if isinstance(v, str):
            v = v.replace(",", " ").split()
        v = [float(x) for x in v]
        if len(v) != 6:
            raise ValueError(f"Invalid unit_cell {orig}")
        return tuple(v)


class MessageOrderResolver:
    """Soft ordering of racing PIA requests (reference: service.py:243-285):
    the first out-of-order message for a group is requeued once."""

    def __init__(self, log=logger):
        self.log = log
        self._expected_next_message_id = 0
        self._current_dcgid = 0

    def should_handle_now(self, message: PiaRequest, header: dict) -> bool:
        if message.dcgid != self._current_dcgid:
            if self._current_dcgid:
                self.log.debug(
                    "new collection group %s - index tracking restarts at 0",
                    message.dcgid,
                )
            self._current_dcgid = message.dcgid
            self._expected_next_message_id = 0

        if message.message_index == self._expected_next_message_id:
            self._expected_next_message_id += 1
        elif header.get("already_requeued", False):
            self.log.info(
                "request %d arrived while %d was still pending and has "
                "already been deferred once - processing it out of order",
                message.message_index,
                self._expected_next_message_id,
            )
        else:
            self.log.info(
                "request %d arrived before %d - deferring it once",
                message.message_index,
                self._expected_next_message_id,
            )
            header["already_requeued"] = True
            return False
        return True


SPOTFINDER_ENV = "FFS_TORCH_SPOTFINDER"
SPOTFINDER_32BIT_ENV = "FFS_TORCH_SPOTFINDER_32BIT"


def find_spotfinder() -> tuple[Path, Path]:
    """Locate the port's spotfinder entry points and verify --list-devices
    (reference: service.py:184-240).  Returns (spotfinder, spotfinder32):
    ``$FFS_TORCH_SPOTFINDER`` or the ``spotfinder_torch`` console script,
    and ``$FFS_TORCH_SPOTFINDER_32BIT`` or ``spotfinder32_torch`` beside
    it."""
    spotfinder_path = os.getenv(SPOTFINDER_ENV) or shutil.which("spotfinder_torch")
    if not spotfinder_path or not Path(spotfinder_path).is_file():
        raise FileNotFoundError(
            "Could not find the spotfinder_torch executable. "
            f"Please set the {SPOTFINDER_ENV} environment variable."
        )
    spotfinder_path = Path(spotfinder_path)
    if subprocess.run(
        [spotfinder_path, "--list-devices"], capture_output=True
    ).returncode:
        raise RuntimeError(
            f"Spotfinder at {spotfinder_path} failed to enumerate devices."
        )
    spotfinder_32 = (
        Path(os.environ[SPOTFINDER_32BIT_ENV])
        if os.getenv(SPOTFINDER_32BIT_ENV)
        else spotfinder_path.parent / "spotfinder32_torch"
    )
    if not spotfinder_32.is_file():
        raise FileNotFoundError("Could not find spotfinder32_torch variant")
    if subprocess.run(
        [spotfinder_32, "--list-devices"], capture_output=True
    ).returncode:
        raise RuntimeError("Found spotfinder32_torch but failed to enumerate devices")
    return spotfinder_path, spotfinder_32


class PiaService:
    """Transport-agnostic core of the per-image-analysis service."""

    def __init__(self, log=logger, threads: int = 40, with_indexer: bool = True):
        """``with_indexer`` builds the port's SSX indexer on
        ``torchinit.select_device()``; a failure to build it raises."""
        self.log = log
        self.threads = threads
        self._spotfinder_executable = find_spotfinder()
        self._order_resolver = MessageOrderResolver(log)
        self._spotfind_proc = None
        self.indexer = None
        self.output_for_index = False
        if with_indexer:
            from ..indexing.ssx import SSXIndexer

            self.indexer = SSXIndexer()

    def handle(self, rw, header: dict, message, base_path="/dev/shm/eiger") -> None:
        """Process one PIA request (reference: service.py:317-520).

        ``rw`` needs: ``recipe_step["parameters"]``, ``transport.ack/nack``,
        ``checkpoint(message, header=, delay=)``, ``send_to(channel, data)``.
        """
        try:
            parameters = PiaRequest(**rw.recipe_step["parameters"])
        except ValidationError as e:
            dcid = rw.recipe_step["parameters"].get("dcid", "(unknown DCID)")
            self.log.warning(f"Rejecting PIA request for {dcid}: \n{e}")
            rw.transport.nack(header, requeue=False)
            return

        try:
            detector_geometry = DetectorGeometry(
                distance=parameters.detector_distance,
                beam_center_x=parameters.xBeam,
                beam_center_y=parameters.yBeam,
                detector={"detector_type": parameters.detector},
            )
        except ValidationError as e:
            self.log.warning(
                f"Rejecting PIA request for {parameters.dcgid}/"
                f"{parameters.message_index}({parameters.dcid}): "
                f"Invalid detector parameters \n{e}"
            )
            rw.transport.nack(header, requeue=False)
            return

        self.output_for_index = False
        if self.indexer and parameters.unit_cell and parameters.wavelength:
            from ..models.geometry import simple_panel

            det = detector_geometry.detector
            mu = det.calculate_mu(parameters.wavelength)
            self.indexer.cell = tuple(parameters.unit_cell)
            self.indexer.panel = simple_panel(
                distance_mm=detector_geometry.distance,
                beam_center_px=(
                    detector_geometry.beam_center_x / det.pixel_size_x,
                    detector_geometry.beam_center_y / det.pixel_size_y,
                ),
                pixel_size_mm=(det.pixel_size_x, det.pixel_size_y),
                image_size=(det.image_size_x, det.image_size_y),
                mu=mu,
                thickness=det.thickness,
                parallax=True,
                material=det.material.name,
            )
            self.indexer.wavelength = parameters.wavelength
            self.output_for_index = True

        start_time = time.monotonic()
        self.log.info(
            f"Gotten PIA request for {parameters.dcgid}/{parameters.message_index}"
            f"({parameters.dcid}): {parameters.filename}/"
            f":{parameters.start_frame_index}-"
            f"{parameters.start_frame_index + parameters.number_of_frames}"
        )

        if not self._order_resolver.should_handle_now(parameters, header):
            rw.transport.ack(header)
            rw.checkpoint(message, header=header, delay=5)
            return

        if parameters.filename.is_absolute():
            data_path = parameters.filename
        elif Path(base_path).is_dir():
            data_path = Path(base_path) / parameters.filename
        else:
            data_path = parameters.filename

        # stale-message rejection (reference: service.py:403-410).
        # Divergence: the reference subtracts a naive now() from the
        # parsed startTime, which raises TypeError when the producer
        # sends an ISO-8601 timestamp with a timezone ('...Z') — every
        # redelivery then crashes before the ack, wedging the queue.
        # Compare in the message's own timezone when it has one.
        if parameters.startTime and Path(base_path).is_dir():
            now = datetime.now(parameters.startTime.tzinfo)
            age = (now - parameters.startTime).total_seconds()
            if age > 60 and not data_path.is_dir():
                self.log.warning(
                    f"Not processing message as too old ({age:.0f} s); "
                    "and no data on disk indicating retrigger"
                )
                rw.transport.ack(header)
                return

        rw.transport.ack(header)

        read_fd, write_fd = os.pipe()
        command = [
            str(self._spotfinder_executable[0]),
            str(data_path),
            "--images",
            str(parameters.number_of_frames),
            "--start-index",
            str(parameters.start_frame_index),
            "--threads",
            str(self.threads),
            "--pipe_fd",
            str(write_fd),
            "--detector",
            detector_geometry.to_json(),
        ]
        if parameters.wavelength is not None:
            command.extend(["--wavelength", str(parameters.wavelength)])
        if parameters.d_min:
            command.extend(["--dmin", str(parameters.d_min)])
        if parameters.d_max:
            command.extend(["--dmax", str(parameters.d_max)])
        if self.output_for_index:
            command.append("--output-for-index")
        # deployment knob (per-beamline Helm values -> env): run the
        # spotfinder in batched collection mode (--batch B, the
        # bench-measured amortised device pipeline).  The CLI falls back
        # to per-frame processing when the packed path is unavailable.
        if os.getenv("FFS_SPOTFIND_BATCH"):
            command.extend(["--batch", os.environ["FFS_SPOTFIND_BATCH"]])

        self.log.info(f"Running: {' '.join(str(x) for x in command)}")

        def read_and_send():
            with os.fdopen(read_fd, "r") as pipe_data:
                for line in pipe_data:
                    line = line.strip()
                    if not line:
                        continue
                    data = json.loads(line)
                    data["file-seen-at"] = time.time()
                    data["file-number"] += 1  # XRC is one-based
                    if self.output_for_index:
                        index_pipe_payload(self.indexer, data)
                    self.log.info(f"Sending: {data}")
                    rw.send_to("result", data)
            self.log.info("Results finished sending")

        reader_thread = threading.Thread(target=read_and_send)
        self._spotfind_proc = subprocess.Popen(command, pass_fds=[write_fd])
        reader_thread.start()

        # exit-code-32 bit-depth renegotiation (reference: service.py:503-507)
        if self._spotfind_proc.wait() == 32:
            self.log.info(
                "Spotfinder exited indicating data is 32-bit, relaunching"
            )
            command[0] = str(self._spotfinder_executable[1])
            self._spotfind_proc = subprocess.Popen(command, pass_fds=[write_fd])
            self._spotfind_proc.wait()

        os.close(write_fd)
        duration = time.monotonic() - start_time
        self.log.info(f"Analysis complete in {duration:.1f} s")
        reader_thread.join()


def zocalo_service_class():
    """Build the zocalo CommonService subclass when workflows is available
    (production deployment; reference: service.py:288-316)."""
    import workflows.recipe
    from workflows.services.common_service import CommonService

    class TorchPerImageAnalysis(CommonService):
        _service_name = "Torch Per-Image-Analysis"
        _logger_name = "spotfinder.service"

        def initializing(self):
            self._core = PiaService(log=self.log)
            workflows.recipe.wrap_subscribe(
                self._transport,
                self._environment.get("queue") or DEFAULT_QUEUE_NAME,
                self.gpu_per_image_analysis,
                acknowledgement=True,
                log_extender=self.extend_log,
            )

        def gpu_per_image_analysis(self, rw, header, message):
            self._core.handle(rw, header, message)

    return TorchPerImageAnalysis


def __getattr__(name: str):
    # lazy module attribute backing the `workflows.services` entry point
    # (pyproject: TorchPerImageAnalysis = "ffs_tpu_torch.service.pia:
    # TorchPerImageAnalysis"): entry_point.load() resolves the attribute,
    # building the CommonService subclass only when workflows is importable
    if name == "TorchPerImageAnalysis":
        return zocalo_service_class()
    raise AttributeError(name)


def main() -> None:
    """Console helper: launch the service under zocalo's runner
    (equivalent to `zocalo.service -s TorchPerImageAnalysis`; the
    entry-point registration makes the service discoverable there)."""
    runner = shutil.which("zocalo.service")
    if runner is None:
        print(
            "workflows/zocalo not installed; use PiaService directly or "
            "install the beamline transport stack.",
            file=sys.stderr,
        )
        sys.exit(1)
    os.execv(
        runner, [runner, "-s", "TorchPerImageAnalysis", *sys.argv[1:]]
    )
