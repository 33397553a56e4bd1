"""DIALS experiment-list (.expt JSON) parsing and writing.

Minimal single-experiment support matching what the reference consumes and
emits (reference: baseline/indexer/indexer.cc:130-167, 446-455; tests embed
the same format, tests/test_predict.py:13-110).
"""

from __future__ import annotations

import json
import uuid
from dataclasses import dataclass, field

import numpy as np

from .crystal import Crystal
from .geometry import Goniometer, MonochromaticBeam, Panel, Scan


@dataclass
class Experiment:
    beam: MonochromaticBeam
    panel: Panel
    goniometer: Goniometer = field(default_factory=Goniometer)
    scan: Scan = field(default_factory=Scan)
    crystal: Crystal | None = None
    identifier: str = ""

    @classmethod
    def from_json_obj(cls, obj: dict) -> "Experiment":
        beam = MonochromaticBeam.from_json(obj["beam"][0])
        panel = Panel.from_json(obj["detector"][0]["panels"][0])
        gonio = (
            Goniometer.from_json(obj["goniometer"][0])
            if obj.get("goniometer")
            else Goniometer()
        )
        scan = Scan.from_json(obj["scan"][0]) if obj.get("scan") else Scan()
        crystal = (
            Crystal.from_json(obj["crystal"][0]) if obj.get("crystal") else None
        )
        ident = ""
        if obj.get("experiment"):
            ident = obj["experiment"][0].get("identifier", "")
        return cls(beam, panel, gonio, scan, crystal, ident)

    @classmethod
    def load(cls, path: str) -> "Experiment":
        with open(path) as f:
            return cls.from_json_obj(json.load(f))

    def to_json_obj(self) -> dict:
        ident = self.identifier or str(uuid.uuid4())
        self.identifier = ident
        exp = {
            "__id__": "ExperimentList",
            "experiment": [
                {
                    "__id__": "Experiment",
                    "identifier": ident,
                    "beam": 0,
                    "detector": 0,
                    "goniometer": 0,
                    "scan": 0,
                }
            ],
            "beam": [
                {
                    "__id__": "monochromatic",
                    "direction": [float(v) for v in self.beam.direction],
                    "wavelength": float(self.beam.wavelength),
                    "divergence": 0.0,
                    "sigma_divergence": 0.0,
                    "polarization_normal": [
                        float(v) for v in self.beam.polarization_normal
                    ],
                    "polarization_fraction": float(
                        self.beam.polarization_fraction
                    ),
                }
            ],
            "detector": [{"panels": [self.panel.to_json()]}],
            "goniometer": [
                {
                    "rotation_axis": [float(v) for v in self.goniometer.rotation_axis],
                    "fixed_rotation": [
                        float(v) for v in self.goniometer.fixed_rotation.ravel()
                    ],
                    "setting_rotation": [
                        float(v) for v in self.goniometer.setting_rotation.ravel()
                    ],
                }
            ],
            "scan": [
                {
                    "image_range": list(self.scan.image_range),
                    "oscillation": list(self.scan.oscillation),
                }
            ],
            "imageset": [],
        }
        if self.crystal is not None:
            exp["crystal"] = [self.crystal.to_json()]
            exp["experiment"][0]["crystal"] = 0
        return exp

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json_obj(), f, indent=4)

    @property
    def d_matrix(self) -> np.ndarray:
        return np.stack(
            [self.panel.fast_axis, self.panel.slow_axis, self.panel.origin], axis=1
        )

    def update_panel_frame(self, fast, slow, origin) -> None:
        self.panel.fast_axis = np.asarray(fast)
        self.panel.slow_axis = np.asarray(slow)
        self.panel.origin = np.asarray(origin)


def experiment_from_state(d: dict) -> Experiment:
    """This package's :class:`Experiment` from plain model state.

    ``d`` maps ``beam``, ``panel``, ``goniometer``, ``scan`` and optionally
    ``crystal`` to the field dictionaries of the models
    (``dataclasses.asdict`` of an experiment of either package: the fields
    are NumPy arrays, floats and tuples), and optionally ``identifier`` to a
    string.  The ``.expt`` JSON (:meth:`Experiment.load`) stays the CLI's
    path; this is how an experiment built elsewhere crosses over whole.
    """
    crystal = d.get("crystal")
    return Experiment(
        beam=MonochromaticBeam(**d["beam"]),
        panel=Panel(**d["panel"]),
        goniometer=Goniometer(**d["goniometer"]),
        scan=Scan(**d["scan"]),
        crystal=None if crystal is None else Crystal(**crystal),
        identifier=d.get("identifier", ""),
    )
