"""Beam / detector / goniometer / scan models (dx2 equivalents).

DIALS laboratory frame conventions: the beam travels approximately along -z
toward the detector (s0 = -direction/wavelength), panel ``fast``/``slow``
axes and ``origin`` are given in mm in the lab frame, and pixel (x, y) maps
to lab coordinates as ``origin + fast * x_mm + slow * y_mm``.

Parallax-corrected px<->mm follows the reference's GPU port of
dx2::Panel::px_to_mm (reference: integrator/kabsch.cu:160-231).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class MonochromaticBeam:
    wavelength: float
    direction: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 1.0])
    )  # unit vector, sample -> source convention as in DIALS expt JSON
    # read by the integrator's LP correction (reference:
    # integrator.cc:1228-1229 via dx2 Beam); DIALS defaults
    polarization_normal: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0])
    )
    polarization_fraction: float = 0.999

    @property
    def s0(self) -> np.ndarray:
        """Incident wavevector, |s0| = 1/wavelength."""
        d = np.asarray(self.direction, dtype=np.float64)
        return -d / np.linalg.norm(d) / self.wavelength

    @classmethod
    def from_json(cls, obj: dict) -> "MonochromaticBeam":
        return cls(
            wavelength=float(obj["wavelength"]),
            direction=np.asarray(obj.get("direction", [0.0, 0.0, 1.0]), dtype=float),
            polarization_normal=np.asarray(
                obj.get("polarization_normal", [0.0, 1.0, 0.0]), dtype=float
            ),
            polarization_fraction=float(obj.get("polarization_fraction", 0.999)),
        )


@dataclass
class Goniometer:
    rotation_axis: np.ndarray = field(
        default_factory=lambda: np.array([1.0, 0.0, 0.0])
    )
    fixed_rotation: np.ndarray = field(default_factory=lambda: np.eye(3))
    setting_rotation: np.ndarray = field(default_factory=lambda: np.eye(3))

    @classmethod
    def from_json(cls, obj: dict) -> "Goniometer":
        return cls(
            rotation_axis=np.asarray(obj.get("rotation_axis", [1, 0, 0]), dtype=float),
            fixed_rotation=np.asarray(
                obj.get("fixed_rotation", np.eye(3).ravel()), dtype=float
            ).reshape(3, 3),
            setting_rotation=np.asarray(
                obj.get("setting_rotation", np.eye(3).ravel()), dtype=float
            ).reshape(3, 3),
        )


@dataclass
class Scan:
    image_range: tuple[int, int] = (1, 1)
    oscillation: tuple[float, float] = (0.0, 0.0)  # (start, width) degrees

    @classmethod
    def from_json(cls, obj: dict) -> "Scan":
        # DIALS serialises either a flat {"oscillation": [start, width]} or
        # the newer {"properties": {"oscillation": [phi_0, phi_1, ...]}}
        # per-image list whose first difference is the width (dx2 Scan
        # parses both; e.g. the thaumatin golden expt uses the latter —
        # reference: tests/test_predict.py:123-133)
        rng = obj.get("image_range", [1, 1])
        props = obj.get("properties") or {}
        if "oscillation" in obj:
            osc = obj["oscillation"]
            start, width = float(osc[0]), float(osc[1])
        elif "oscillation" in props:
            seq = [float(v) for v in props["oscillation"]]
            start = seq[0] if seq else 0.0
            width = (seq[1] - seq[0]) if len(seq) > 1 else 0.0
        else:
            start, width = 0.0, 0.0
        return cls(image_range=(int(rng[0]), int(rng[1])), oscillation=(start, width))


@dataclass
class Panel:
    fast_axis: np.ndarray
    slow_axis: np.ndarray
    origin: np.ndarray  # mm
    pixel_size: tuple[float, float]  # mm (fast, slow)
    image_size: tuple[int, int]  # px (fast, slow)
    trusted_range: tuple[float, float] = (0.0, float("inf"))
    mu: float = 0.0  # linear attenuation coefficient (mm^-1)
    thickness: float = 0.0  # sensor thickness (mm)
    parallax: bool = False
    material: str = ""  # sensor material ("Si", "CdTe", ...)

    @classmethod
    def from_json(cls, obj: dict) -> "Panel":
        strategy = obj.get("px_mm_strategy", {}).get("type", "SimplePxMmStrategy")
        return cls(
            fast_axis=np.asarray(obj["fast_axis"], dtype=float),
            slow_axis=np.asarray(obj["slow_axis"], dtype=float),
            origin=np.asarray(obj["origin"], dtype=float),
            pixel_size=tuple(obj["pixel_size"]),
            image_size=tuple(obj["image_size"]),
            trusted_range=tuple(obj.get("trusted_range", (0.0, float("inf")))),
            mu=float(obj.get("mu", 0.0)),
            thickness=float(obj.get("thickness", 0.0)),
            parallax=strategy == "ParallaxCorrectedPxMmStrategy",
            material=str(obj.get("material", "")),
        )

    def to_json(self) -> dict:
        return {
            "name": "/entry/instrument/detector/module",
            "type": "SENSOR_PAD",
            "fast_axis": list(map(float, self.fast_axis)),
            "slow_axis": list(map(float, self.slow_axis)),
            "origin": list(map(float, self.origin)),
            "raw_image_offset": [0, 0],
            "image_size": list(self.image_size),
            "pixel_size": list(self.pixel_size),
            # an unbounded trusted max serialises as the float64 max:
            # the raw inf would emit the non-RFC "Infinity" token, which
            # strict parsers (nlohmann::json, JSON.parse) reject
            "trusted_range": [
                v if np.isfinite(v) else np.finfo(np.float64).max
                for v in map(float, self.trusted_range)
            ],
            "thickness": self.thickness,
            "material": self.material or ("Si" if self.mu else ""),
            "mu": self.mu,
            "identifier": "",
            "mask": [],
            "gain": 1.0,
            "pedestal": 0.0,
            "px_mm_strategy": {
                "type": "ParallaxCorrectedPxMmStrategy"
                if self.parallax
                else "SimplePxMmStrategy"
            },
        }

    # --- geometry ---------------------------------------------------------

    @property
    def normal(self) -> np.ndarray:
        n = np.cross(self.fast_axis, self.slow_axis)
        if np.dot(self.origin, n) < 0:
            n = -n
        return n

    def attenuation_length(self, s1_hat: np.ndarray) -> np.ndarray:
        """Mean absorption path length o (mm) for unit ray(s) s1_hat
        (reference: kabsch.cu:160-190)."""
        cos_t = s1_hat @ self.normal
        return (1.0 / self.mu) - (self.thickness / cos_t + 1.0 / self.mu) * np.exp(
            -self.mu * self.thickness / cos_t
        )

    def px_to_mm(self, x: np.ndarray, y: np.ndarray):
        """Pixel -> mm, vectorised; applies parallax correction if enabled
        (reference: kabsch.cu:192-231)."""
        x1 = np.asarray(x, dtype=np.float64) * self.pixel_size[0]
        x2 = np.asarray(y, dtype=np.float64) * self.pixel_size[1]
        if not self.parallax:
            return x1, x2
        lab = (
            self.origin
            + np.multiply.outer(x1, self.fast_axis)
            + np.multiply.outer(x2, self.slow_axis)
        )
        s1 = lab / np.linalg.norm(lab, axis=-1, keepdims=True)
        o = self.attenuation_length(s1)
        return x1 - (s1 @ self.fast_axis) * o, x2 - (s1 @ self.slow_axis) * o

    def mm_to_px(self, xmm: np.ndarray, ymm: np.ndarray):
        """mm -> pixel, inverting the parallax correction (DIALS convention:
        correction applied forward from the true intersection)."""
        if not self.parallax:
            return (
                np.asarray(xmm) / self.pixel_size[0],
                np.asarray(ymm) / self.pixel_size[1],
            )
        lab = (
            self.origin
            + np.multiply.outer(np.asarray(xmm, dtype=float), self.fast_axis)
            + np.multiply.outer(np.asarray(ymm, dtype=float), self.slow_axis)
        )
        s1 = lab / np.linalg.norm(lab, axis=-1, keepdims=True)
        o = self.attenuation_length(s1)
        return (
            (xmm + (s1 @ self.fast_axis) * o) / self.pixel_size[0],
            (ymm + (s1 @ self.slow_axis) * o) / self.pixel_size[1],
        )

    def get_lab_coord(self, xmm: np.ndarray, ymm: np.ndarray) -> np.ndarray:
        """Lab coordinate(s) of mm position(s); broadcasts over leading dims."""
        return (
            self.origin
            + np.multiply.outer(np.asarray(xmm, dtype=float), self.fast_axis)
            + np.multiply.outer(np.asarray(ymm, dtype=float), self.slow_axis)
        )

    def get_ray_intersection(self, s1: np.ndarray):
        """Intersect ray direction(s) s1 with the panel plane -> (xmm, ymm)
        in panel-frame mm (DIALS d-matrix solve: s1 ~ d @ (x, y, 1))."""
        s1 = np.asarray(s1, dtype=float)
        d_mat = np.stack([self.fast_axis, self.slow_axis, self.origin], axis=1)
        v = s1 @ np.linalg.inv(d_mat).T
        with np.errstate(divide="ignore", invalid="ignore"):
            return v[..., 0] / v[..., 2], v[..., 1] / v[..., 2]


def simple_panel(
    distance_mm: float,
    beam_center_px: tuple[float, float],
    pixel_size_mm: tuple[float, float],
    image_size: tuple[int, int],
    trusted_range: tuple[float, float] = (0.0, float("inf")),
    mu: float = 0.0,
    thickness: float = 0.0,
    parallax: bool = False,
    material: str = "",
) -> Panel:
    """Perpendicular-detector panel, as the reference builds in the
    spotfinder epilogue (reference: spotfinder/spotfinder.cc:1157-1162):
    beam along -z, fast = +x, slow = -y, origin at the beam centre offset.

    ``beam_center_px`` and ``pixel_size_mm`` are (x=fast, y=slow).
    """
    bx = beam_center_px[0] * pixel_size_mm[0]
    by = beam_center_px[1] * pixel_size_mm[1]
    return Panel(
        fast_axis=np.array([1.0, 0.0, 0.0]),
        slow_axis=np.array([0.0, -1.0, 0.0]),
        origin=np.array([-bx, by, -distance_mm]),
        pixel_size=tuple(pixel_size_mm),
        image_size=tuple(image_size),
        trusted_range=trusted_range,
        mu=mu,
        thickness=thickness,
        parallax=parallax,
        material=material,
    )
