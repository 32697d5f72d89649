"""Per-window stage timer / flight recorder (docs/observability.md).

A preallocated ring of serving-window records: each window that flows
through ``TickLoop`` → ``TickEngine``/``MeshTickEngine`` gets one row
holding its per-stage wall time (decode, arena lease, pack, H2D
dispatch, tick, resolve, encode) plus queue depth and batch width.

The port's copy of the JAX package's ``utils/flightrec``.  Gating
mirrors ``tracing.enabled()``: recording happens only while a recorder
is installed (``install()``), so an un-instrumented daemon pays a single
``is None`` check per window.  The record path is host-scalar writes
into preallocated numpy arrays, no device syncs, no locks on the
per-stage ``note`` path (each (window, stage) cell has exactly one
writer).

Stage semantics:

- ``decode``/``encode`` are transport edges recorded per request batch
  via ``edge()``; decode time accumulates and folds into the *next*
  window begun, encode attaches to the most recently finished window
  (a window's decode is the CPU that fed it; its encode trails it).
- ``pack`` includes the arena ``lease`` (also broken out separately);
  ``ssd`` is the miss path's batched slab-store lookup, broken OUT of
  ``pack`` (the engine subtracts it), so a pack regression can't hide
  SSD I/O and vice versa.
- ``tick`` is the shared D2H wait of the resolver drain that resolved
  the window; windows resolved in one drain report the same tick time.

The slow-window watchdog is split so the hot path stays cheap:
``finish()`` only compares the row total against ``slow_threshold_s``
and parks offenders in a small deque; a supervised loop in the daemon
drains them (``drain_slow()``), dumps each record, and bumps
``gubernator_tpu_slow_windows``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np


STAGES = (
    "decode", "lease", "pack", "ssd", "h2d", "tick", "resolve", "encode",
)
_IDX = {s: i for i, s in enumerate(STAGES)}
_DECODE = _IDX["decode"]
_ENCODE = _IDX["encode"]


def _percentiles(seconds: np.ndarray) -> Dict[str, float]:
    """p50/p99 in ms of the nonzero cells (a stage that never ran in a
    window is left out); 0.0 for none."""
    col = seconds[seconds > 0.0]
    if col.size == 0:
        return {"p50_ms": 0.0, "p99_ms": 0.0}
    return {"p50_ms": round(float(np.percentile(col, 50)) * 1e3, 4),
            "p99_ms": round(float(np.percentile(col, 99)) * 1e3, 4)}


class FlightRecorder:
    """Preallocated ring of per-window stage records."""

    def __init__(
        self,
        windows: int = 256,
        clock: Callable[[], float] = time.time,
        slow_threshold_s: float = 0.0,
    ):
        if windows < 2:
            raise ValueError("flight recorder needs at least 2 windows")
        self.windows = windows
        self.clock = clock
        self.slow_threshold_s = slow_threshold_s
        # Optional sink: called as observer(stage, seconds) at finish()
        # (the daemon wires it to the per-stage latency histogram).
        self.observer: Optional[Callable[[str, float], None]] = None
        self._lock = threading.Lock()
        self._stage_s = np.zeros((windows, len(STAGES)), np.float64)
        self._width = np.zeros(windows, np.int64)
        self._depth = np.zeros(windows, np.int64)
        self._wall = np.zeros(windows, np.float64)
        self._valid = np.zeros(windows, bool)
        self._seq = 0
        self._active: Optional[int] = None
        self._pending_decode = 0.0
        self.slow_total = 0
        self._slow: deque = deque(maxlen=32)

    # -- record path (hot) ---------------------------------------------
    def begin(self, width: int, depth: int) -> int:
        """Open a window record at dispatch time; returns its id."""
        with self._lock:
            wid = self._seq
            self._seq = wid + 1
            slot = wid % self.windows
            self._stage_s[slot, :] = 0.0
            self._valid[slot] = False
            self._width[slot] = width
            self._depth[slot] = depth
            self._wall[slot] = self.clock()
            self._stage_s[slot, _DECODE] = self._pending_decode
            self._pending_decode = 0.0
            self._active = wid
        return wid

    def note(self, wid: Optional[int], stage: str, seconds: float) -> None:
        """Accumulate ``seconds`` into one stage cell of window ``wid``."""
        if wid is None or wid < 0 or self._seq - wid > self.windows:
            return
        self._stage_s[wid % self.windows, _IDX[stage]] += seconds

    def finish(self, wid: int) -> None:
        """Seal a window record; runs the cheap slow-window check."""
        if wid < 0 or self._seq - wid > self.windows:
            return
        slot = wid % self.windows
        self._valid[slot] = True
        obs = self.observer
        if obs is not None:
            row = self._stage_s[slot]
            for stage, i in _IDX.items():
                if row[i] > 0.0:
                    obs(stage, row[i])
        thresh = self.slow_threshold_s
        if thresh > 0.0:
            total = self._stage_s[slot].sum()
            if total > thresh:
                with self._lock:
                    self.slow_total += 1
                    self._slow.append((
                        wid,
                        self._stage_s[slot].copy(),
                        self._width[slot],
                        self._depth[slot],
                        self._wall[slot],
                    ))

    def active(self) -> Optional[int]:
        """Window id currently in engine dispatch (``None`` between)."""
        return self._active

    def end_dispatch(self, wid: int) -> None:
        if self._active == wid:
            self._active = None

    def edge(self, stage: str, seconds: float) -> None:
        """Record a transport-edge stage (decode/encode) for one batch."""
        if stage == "decode":
            with self._lock:
                self._pending_decode += seconds
        else:
            with self._lock:
                last = self._seq - 1
                if last >= 0:
                    self._stage_s[last % self.windows, _ENCODE] += seconds
        obs = self.observer
        if obs is not None:
            obs(stage, seconds)

    # -- read path -----------------------------------------------------
    def recent(self, n: int = 64) -> List[dict]:
        """Finished window records, oldest→newest, as JSON-ready dicts."""
        out: List[dict] = []
        with self._lock:
            seq = self._seq
            lo = max(0, seq - min(n, self.windows))
            for wid in range(lo, seq):
                slot = wid % self.windows
                if not self._valid[slot]:
                    continue
                stages = {
                    s: round(float(self._stage_s[slot, i]) * 1e3, 4)
                    for s, i in _IDX.items()
                }
                out.append({
                    "window": wid,
                    "wall": float(self._wall[slot]),
                    "width": int(self._width[slot]),
                    "queue_depth": int(self._depth[slot]),
                    "stages_ms": stages,
                    "total_ms": round(sum(stages.values()), 4),
                })
        return out

    def stage_percentiles(self) -> Dict[str, Dict[str, float]]:
        """Per-stage p50/p99 (ms) over finished windows in the ring.
        Zero cells (stage never ran in that window) are excluded."""
        with self._lock:
            mask = self._valid.copy()
            stage_s = self._stage_s.copy()
        return {s: _percentiles(stage_s[mask, i]) for s, i in _IDX.items()}

    def snapshot(self) -> dict:
        """Per-stage and whole-window p50/p99 (ms) plus ring metadata: the
        control plane's view (the autoscaler, /debug/autoscaler), one
        lock-copy on the controller's cadence."""
        with self._lock:
            mask = self._valid.copy()
            stage_s = self._stage_s.copy()
            slow_total = self.slow_total
        return {
            "stages": {s: _percentiles(stage_s[mask, i])
                       for s, i in _IDX.items()},
            "total": _percentiles(stage_s[mask].sum(axis=1)),
            "windows": int(mask.sum()),
            "ring_size": self.windows,
            "slow_total": slow_total,
        }

    def drain_slow(self) -> List[dict]:
        """Pop pending slow-window dumps (watchdog loop calls this)."""
        out: List[dict] = []
        with self._lock:
            while self._slow:
                wid, row, width, depth, wall = self._slow.popleft()
                out.append({
                    "window": int(wid),
                    "wall": float(wall),
                    "width": int(width),
                    "queue_depth": int(depth),
                    "stages_ms": {
                        s: round(float(row[i]) * 1e3, 4)
                        for s, i in _IDX.items()
                    },
                    "total_ms": round(float(row.sum()) * 1e3, 4),
                })
        return out


# ---------------------------------------------------------------------
# Process-global recorder slot (mirrors tracing's global tracer: the
# in-process test cluster shares one recorder across daemons).
_recorder: Optional[FlightRecorder] = None


def install(recorder: FlightRecorder) -> None:
    global _recorder
    _recorder = recorder


def uninstall() -> None:
    global _recorder
    _recorder = None


def get() -> Optional[FlightRecorder]:
    return _recorder

