"""X-ray-centring result comparison service.

Equivalent of the reference XRCResultCompare (reference:
src/ffs/compare_service.py:23-126): pairs GPU- and CPU-produced XRC results
for the same data collection and diffs them.  Transport-agnostic core plus
an optional zocalo wrapper, mirroring :mod:`.pia`.

The port's copy of :mod:`ffs_tpu.service.compare` (it uses no framework):
its logger is ``ffs_tpu_torch.compare`` and its ``workflows.services`` entry
point ``TorchXRCResultCompare``.

Deliberate divergence: when two results from the SAME implementation
arrive for one DCID the reference nacks both headers and then falls
through to ack them as well (compare_service.py:116-126 — the error
branch is missing a return, double-settling both messages; transports
typically raise or warn on the second settle).  We return after the
nacks so each message is settled exactly once.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Tuple

from pydantic import BaseModel, ValidationError

logger = logging.getLogger("ffs_tpu_torch.compare")

DEFAULT_QUEUE_NAME = "reduce.xray_centering.gpu.compare_results"

Coordinate = Tuple[int, int, int]


class XRCResult(BaseModel):
    centre_of_mass: list[float]
    max_voxel: list[int]
    max_count: int
    n_voxels: int
    total_count: int
    bounding_box: tuple[Coordinate, Coordinate]


class XRCOutput(BaseModel):
    results: list[XRCResult]
    success: bool
    type: str


class Parameters(BaseModel):
    dcid: int
    gpu: bool = False


class Result(BaseModel):
    timestamp: float
    results: list[XRCResult]
    gpu: bool
    header: Any


class XRCCompareCore:
    """Pairs per-DCID results from the two implementations."""

    def __init__(self, log=logger):
        self.log = log
        self._result: dict[int, Result] = {}

    def compare_xrc(self, rw, header: dict, message: dict) -> None:
        try:
            output = XRCOutput.model_validate(message)
            params = Parameters.model_validate(rw.recipe_step["parameters"])
        except ValidationError as e:
            dcid = rw.recipe_step["parameters"].get("dcid", "(unknown DCID)")
            self.log.warning(f"Rejecting XRC result for {dcid}: \n{e}")
            rw.transport.nack(header, requeue=False)
            return

        is_gpu = bool(rw.recipe_step["parameters"].get("gpu"))
        self.log.info(
            f"Gotten XRC Result for {params.dcid} ({'GPU' if is_gpu else 'CPU'})"
        )
        result = Result(
            timestamp=time.time(), results=output.results, gpu=is_gpu, header=header
        )
        if params.dcid not in self._result:
            self._result[params.dcid] = result
            return

        other = self._result.pop(params.dcid)
        if other.gpu == result.gpu:
            self.log.error(
                f"Error: Got multiple {'GPU' if is_gpu else 'CPU'} results for "
                f"{params.dcid}"
            )
            rw.transport.nack(header, requeue=False)
            rw.transport.nack(other.header, requeue=False)
            return

        self.log.info(
            f"Compared results:\n{result.results=}\n{other.results=}"
        )
        rw.transport.ack(header)
        rw.transport.ack(other.header)


def zocalo_service_class():
    import workflows.recipe
    from workflows.services.common_service import CommonService

    class TorchXRCResultCompare(CommonService):
        _service_name = "Torch XRC Result Compare"
        _logger_name = "spotfinder.compare"

        def initializing(self):
            self._core = XRCCompareCore(self.log)
            workflows.recipe.wrap_subscribe(
                self._transport,
                self._environment.get("queue") or DEFAULT_QUEUE_NAME,
                self._core.compare_xrc,
                acknowledgement=True,
                log_extender=self.extend_log,
            )

    return TorchXRCResultCompare


def __getattr__(name: str):
    # lazy module attribute backing the `workflows.services` entry point
    # (pyproject: TorchXRCResultCompare = "ffs_tpu_torch.service.compare:
    # TorchXRCResultCompare", mirroring the reference's registration)
    if name == "TorchXRCResultCompare":
        return zocalo_service_class()
    raise AttributeError(name)
