"""Profiling: scoped timers + START/END event stream.

A copy of vofod_tpu/runtime/profiling.py (the original's package import
loads JAX), held to it by tests/test_torch_shared_copies.py.  One addition:
an event may carry a given stamp, so the node can emit the per-routine
device times it reads back after a scan (``NodeOptions.profile_stages``);
``torch.profiler`` traces are the node's ``trace_dir`` window.

Mirrors the reference's mrs_lib::ScopeTimer checkpoints and the
ProfilingInfo publisher (publish_profile_start/end,
vofod_nodelet.cpp:2178-2203), emitted host-side around device dispatches.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable

from vofod_tpu_torch.io.msgs import ProfilingInfo


@dataclass
class ScopeTimer:
    """Named checkpoints relative to construction (ref mrs_lib::ScopeTimer)."""

    name: str
    sink: Callable[[str], None] | None = None
    _t0: float = field(default_factory=time.perf_counter)
    _last: float = 0.0
    checkpoints: list[tuple[str, float]] = field(default_factory=list)

    def checkpoint(self, label: str) -> float:
        now = time.perf_counter() - self._t0
        dt = now - self._last
        self._last = now
        self.checkpoints.append((label, dt))
        if self.sink:
            self.sink(f"[{self.name}] {label}: {dt * 1e3:.2f} ms")
        return dt

    def total(self) -> float:
        return time.perf_counter() - self._t0


class ProfilingStream:
    """START/END event records with per-routine sequence numbers."""

    def set_publisher(self, publish: Callable[[ProfilingInfo], None]) -> None:
        """Attach/replace the event sink after construction (e.g. the ROS
        adapter wiring ~profiling_info once rospy publishers exist)."""
        self._publish = publish

    def __init__(self, publish: Callable[[ProfilingInfo], None] | None = None):
        self._seq: dict[int, int] = {}
        self._publish = publish
        self.events: list[ProfilingInfo] = []

    def _emit(self, routine_id: int, event_type: int, stamp: float | None = None):
        seq = self._seq.get(routine_id, 0)
        evt = ProfilingInfo(
            stamp=time.time() if stamp is None else stamp,
            routine_id=routine_id,
            event_sequence=seq,
            event_type=event_type,
        )
        if event_type == ProfilingInfo.EVENT_END:
            self._seq[routine_id] = seq + 1
        self.events.append(evt)
        if self._publish:
            self._publish(evt)

    def start(self, routine_id: int, stamp: float | None = None):
        self._emit(routine_id, ProfilingInfo.EVENT_START, stamp)

    def end(self, routine_id: int, stamp: float | None = None):
        self._emit(routine_id, ProfilingInfo.EVENT_END, stamp)

    @contextlib.contextmanager
    def routine(self, routine_id: int):
        self.start(routine_id)
        try:
            yield
        finally:
            self.end(routine_id)
