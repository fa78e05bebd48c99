"""Streaming runtime: sensor producer -> ring buffer -> detector loop.

PyTorch counterpart of vofod_tpu/runtime/stream.py.  The reference's
runtime is free-running subscriber loops (pointcloud_loop /
rangefinder_loop, vofod_nodelet.cpp:1102-1122) draining a depth-limited
queue, plus a 10 Hz status loop (:1331-1386).  Here one consumer thread
drains the native SPSC ring (io/scan_queue.py) into the node's step; when
the producer outruns the detector the ring drops frames and counts them —
the back-pressure the reference gets from its subscriber queue depth (the
detector always works on fresh scans).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from vofod_tpu_torch.io.msgs import Detections, Status
from vofod_tpu_torch.io.scan_queue import ScanQueue
from vofod_tpu_torch.runtime.node import VoFOD


@dataclass
class StreamStats:
    processed: int = 0
    dropped: int = 0
    last_period_s: float = 0.0
    started_at: float = field(default_factory=time.time)

    @property
    def rate_hz(self) -> float:
        dt = time.time() - self.started_at
        return self.processed / dt if dt > 0 else 0.0


class StreamRunner:
    """Consumer loop feeding a VoFOD node from a ScanQueue."""

    def __init__(
        self,
        node: VoFOD,
        queue: ScanQueue | None = None,
        on_detections: Callable[[Detections], None] | None = None,
        on_status: Callable[[Status], None] | None = None,
        status_period_s: float = 0.1,  # ref 10 Hz status loop (:1331)
        poll_s: float = 0.0005,
        no_message_timeout_s: float = 5.0,  # ref subscriber timeout (:245)
        on_warning: Callable[[str], None] | None = None,
        pipeline_depth: int = 1,
    ):
        """``pipeline_depth``: scans dispatched ahead of the result fetch.
        With the default 1, scan k+1's host work (upload, kernel launches)
        overlaps scan k's device work: the node's ``process_scan_async``
        returns once the step is enqueued, so the consumer thread waits
        only on the PREVIOUS scan's readback (``fetch_result``).  0 = fully
        synchronous."""
        self.node = node
        self.pipeline_depth = int(pipeline_depth)
        self.queue = queue or ScanQueue(node.cfg.sensor.n_points, capacity=4)
        self.on_detections = on_detections
        self.on_status = on_status
        self.status_period_s = status_period_s
        self.poll_s = poll_s
        self.no_message_timeout_s = no_message_timeout_s
        self.on_warning = on_warning
        self.stats = StreamStats()
        self.inflight = 0  # dispatched scans not yet fetched (loop-owned)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # producer-side API (called from the sensor / reader thread)
    def push(
        self, ranges_mm: np.ndarray, pose: np.ndarray,
        intensity: np.ndarray | None = None,
    ) -> bool:
        ok = self.queue.push(ranges_mm, pose, intensity=intensity)
        if not ok:
            self.stats.dropped = self.queue.dropped
        return ok

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout)
            self._thread = None

    def drain(self, timeout: float = 60.0):
        """Block until the queue is empty and the dispatch pipeline has
        flushed (tests / recording replay)."""
        t0 = time.time()
        while (
            len(self.queue) > 0 or self.inflight > 0
        ) and time.time() - t0 < timeout:
            time.sleep(self.poll_s)

    def _loop(self):
        last_status = 0.0
        t_prev = None
        last_msg = time.time()
        warned = False
        pending: list = []  # dispatched-not-yet-fetched scans

        def deliver(handle):
            nonlocal t_prev
            msg = self.node.fetch_result(handle)
            self.stats.processed += 1
            self.stats.dropped = self.queue.dropped
            now = time.perf_counter()
            if t_prev is not None:
                self.stats.last_period_s = now - t_prev
            t_prev = now
            if self.on_detections is not None:
                self.on_detections(msg)

        while not self._stop.is_set():
            # claim a potential pop BEFORE it leaves the queue: drain() must
            # never observe queue-empty AND inflight == 0 while a scan is in
            # hand between pop() and pending.append() (it would return with
            # the final scan's result unfetched)
            self.inflight = len(pending) + 1
            item = self.queue.pop()
            if item is None:
                self.inflight = len(pending)
                # nothing new: flush the pipeline so results never stall
                # behind an idle sensor
                while pending:
                    deliver(pending.pop(0))
                    self.inflight = len(pending)
                time.sleep(self.poll_s)
                if (
                    not warned
                    and self.on_warning is not None
                    and time.time() - last_msg > self.no_message_timeout_s
                ):
                    warned = True
                    self.on_warning(
                        f"no scans for {self.no_message_timeout_s:.0f}s"
                    )
            else:
                last_msg = time.time()
                warned = False
                ranges, inten, pose = item
                pending.append(
                    self.node.process_scan_async(
                        ranges, inten, pose, time.time()
                    )
                )
                self.inflight = len(pending)
                while len(pending) > self.pipeline_depth:
                    deliver(pending.pop(0))
                    self.inflight = len(pending)
            if (
                self.on_status is not None
                and time.time() - last_status >= self.status_period_s
            ):
                last_status = time.time()
                self.on_status(self.node.status())
        while pending:
            deliver(pending.pop(0))
            self.inflight = len(pending)
