"""Process-global serving metrics with a JSON snapshot endpoint (a copy of
realtime_video_tpu/serving/metrics.py, which cannot be imported without JAX).

The reference server exposes no metrics surface at all (release_server.py
logs only); this is the minimal operational telemetry a production
deployment needs: session counts, frame throughput, and time-to-first-frame
— the two north stars BASELINE.md tracks (fps, p50 TTFF) measured on live
traffic rather than only in bench.py.

Thread-safe: frame callbacks fire from the asyncio loop while sessions run
in executors.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional


class ServingMetrics:
    def __init__(self, window: int = 256) -> None:
        self._lock = threading.Lock()
        self._start = time.time()
        self._sessions_active = 0
        self._sessions_total = 0
        self._frames_total = 0
        self._ttff_ms: deque = deque(maxlen=window)  # per-session TTFF
        self._frame_ts: deque = deque(maxlen=window)  # recent send times
        self._first_frame_pending: Dict[str, float] = {}

    def session_started(self, session_id: str) -> None:
        with self._lock:
            self._sessions_active += 1
            self._sessions_total += 1
            self._first_frame_pending[session_id] = time.time()

    def session_ended(self, session_id: str) -> None:
        with self._lock:
            self._sessions_active = max(0, self._sessions_active - 1)
            self._first_frame_pending.pop(session_id, None)

    def frame_sent(self, session_id: str) -> None:
        now = time.time()
        with self._lock:
            self._frames_total += 1
            self._frame_ts.append(now)
            t0 = self._first_frame_pending.pop(session_id, None)
            if t0 is not None:
                self._ttff_ms.append((now - t0) * 1000.0)

    @staticmethod
    def _pctile(values, q: float) -> Optional[float]:
        if not values:
            return None
        s = sorted(values)
        return s[min(len(s) - 1, int(q * len(s)))]

    def snapshot(self) -> dict:
        with self._lock:
            now = time.time()
            # throughput over the retained frame-timestamp window, ignoring
            # idle gaps older than 60 s so a quiet server reports ~0 fps
            recent = [t for t in self._frame_ts if now - t <= 60.0]
            fps = None
            if len(recent) >= 2 and recent[-1] > recent[0]:
                fps = (len(recent) - 1) / (recent[-1] - recent[0])
            ttff = list(self._ttff_ms)
            return {
                "uptime_s": round(now - self._start, 1),
                "sessions_active": self._sessions_active,
                "sessions_total": self._sessions_total,
                "frames_sent_total": self._frames_total,
                "fps_60s": round(fps, 3) if fps is not None else None,
                "ttff_ms_p50": self._pctile(ttff, 0.50),
                "ttff_ms_p90": self._pctile(ttff, 0.90),
                "ttff_ms_last": ttff[-1] if ttff else None,
            }


METRICS = ServingMetrics()
