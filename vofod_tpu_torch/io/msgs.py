"""Wire-format dataclasses mirroring the reference's ROS messages (msgs/*.msg).

A copy of vofod_tpu/io/msgs.py (the original's package import loads JAX).

These are the framework's public output API; the optional ROS adapter maps
them 1:1 onto the reference topics.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Header:
    stamp: float = 0.0  # seconds
    frame_id: str = ""


@dataclass
class Detection:
    """msgs/Detection.msg:1-12."""

    id: int = 0
    confidence: float = 0.0
    n_points: int = 0
    position: tuple[float, float, float] = (0.0, 0.0, 0.0)
    covariance: tuple[float, ...] = (0.0,) * 9  # row-major 3x3
    detection_probability: float = 0.0


@dataclass
class Detections:
    """msgs/Detections.msg:1-2."""

    header: Header = field(default_factory=Header)
    detections: list[Detection] = field(default_factory=list)


@dataclass
class Status:
    """msgs/Status.msg:1-3."""

    header: Header = field(default_factory=Header)
    detection_enabled: bool = False
    detection_active: bool = False


@dataclass
class ProfilingInfo:
    """msgs/ProfilingInfo.msg:1-7 (START/END event stream)."""

    EVENT_START = 0
    EVENT_END = 1
    # routine ids (ref profile_routines_t, vofod_nodelet.cpp:132-138)
    ROUTINE_CNC = 1
    ROUTINE_SEPBGCLUSTERS = 2
    ROUTINE_RAYCASTING = 3

    stamp: float = 0.0
    routine_id: int = 0
    event_sequence: int = 0
    event_type: int = 0
