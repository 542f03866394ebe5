# A copy of `orbslam2_tpu.utils.eventlog`, which imports no JAX, kept so that the port imports
# nothing of the reference package; tests/test_torch_no_jax.py holds the
# two equal.
"""Structured per-frame event stream for a SLAM session.

The reference scatters session telemetry over `cout` prints (e.g.
src/Tracking.cc:259-264 timing, src/LoopClosing.cc:49-52 detections,
src/Optimizer.cc GBA progress). Here every notable event is one JSON-able
record in an append-only host-side log: per-frame tracking outcomes
(state, inlier count, keyframe flag), keyframe insertions, loop
detections/corrections, relocalizations, resets, and censoring counters
(observation-slot / essential-edge truncation).

Design constraint: emitting an event must never add a device round trip —
records are built ONLY from scalars the pipeline already pulled for its
own bookkeeping (the turbo path's single `jax.device_get` per frame).
"""

from __future__ import annotations

import json
from typing import Any, Optional


class EventLog:
    """Append-only structured event log with optional JSONL streaming.

    Usage:
        log = EventLog(path="session.jsonl")     # or EventLog() in-memory
        log.emit("frame", frame_id=3, state="OK", n_inliers=212, is_kf=False)
        log.counts()["frame"]                    # -> 1
    """

    def __init__(self, path: Optional[str] = None):
        self.events: list[dict[str, Any]] = []
        self._fh = open(path, "w") if path else None

    def emit(self, kind: str, **fields: Any) -> None:
        rec = {"event": kind, **fields}
        self.events.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.events:
            out[e["event"]] = out.get(e["event"], 0) + 1
        return out

    def of(self, kind: str) -> list[dict[str, Any]]:
        return [e for e in self.events if e["event"] == kind]

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            for e in self.events:
                fh.write(json.dumps(e) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
