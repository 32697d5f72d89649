"""Supervised background loop feeding the snapshot store.

Every ``GUBER_SNAPSHOT_INTERVAL`` the writer drains the engine's dirty
set — ``export_columns(dirty_only=True)`` covers both the device table
and the cold tier (engine ``_export_with_cold``) — and appends the delta
to the :class:`SnapshotStore`.  After ``deltas_per_base`` appended
records it compacts: one full export becomes the next generation's base
and the delta log restarts.  The loop runs under ``spawn_supervised``
(a crashed flush logs, counts a restart, and comes back), and all engine
export / disk work runs in the default executor so a multi-MB delta
never stalls the event loop.

Loss bound: the engine resets its dirty set the moment ``export_columns``
returns, so a delta that then fails to reach disk would silently vanish —
the writer therefore *carries* failed deltas and prepends them to the
next flush (upsert replay order keeps last-write-wins).  A hard kill
loses at most the dirty set accumulated since the last fsync'd delta —
one snapshot interval; a graceful :meth:`close` writes a final FULL base,
so clean shutdown loses nothing.

The port's copy of the JAX package's ``persistence/writer.py``:
the same behavior and on-disk format, pure host code (numpy), with
plain ``threading`` locks.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import List, Optional

from gubernator_tpu_torch.persistence.snapshot import SnapshotStore, snapshot_items
from gubernator_tpu_torch.resilience.supervisor import spawn_supervised

log = logging.getLogger("gubernator.persistence")


class SnapshotWriter:
    """Owns the delta-flush cadence for one engine + store pair."""

    def __init__(
        self,
        engine,
        store: SnapshotStore,
        interval: float = 5.0,
        deltas_per_base: int = 64,
        metrics=None,
    ):
        self.engine = engine
        self.store = store
        self.interval = interval
        self.deltas_per_base = max(1, int(deltas_per_base))
        self.metrics = metrics
        self._running = True
        self._carry: List[dict] = []  # deltas that failed to reach disk
        # Serializes flush/write_base bodies: close() can cancel the
        # loop task while its executor thread is still inside flush(),
        # then run the final base on another thread — the store's log
        # rotation must never interleave with an append.
        self._write_lock = threading.Lock()
        self._task: Optional[asyncio.Task] = None
        # Host-side counters (mirrored into Prometheus when wired).
        self.metric_delta_writes = 0
        self.metric_base_writes = 0
        self.metric_items_written = 0
        self.metric_write_failures = 0

    def start(self) -> None:
        """Spawn the supervised flush loop on the running event loop."""
        if self._task is None:
            self._task = spawn_supervised(
                self._loop, name="snapshot-writer",
                should_restart=lambda: self._running,
                metrics=self.metrics, loop_label="snapshot_writer",
            )

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        while self._running:
            await asyncio.sleep(self.interval)
            if not self._running:
                return
            await loop.run_in_executor(None, self.flush)

    # ------------------------------------------------------------------
    def _observe(self, kind: str, dt: float, items: int) -> None:
        if self.metrics is not None:
            self.metrics.snapshot_writes.labels(kind=kind).inc()
            self.metrics.snapshot_duration.labels(kind=kind).observe(dt)
            if items:
                self.metrics.snapshot_items.labels(kind=kind).inc(items)

    def flush(self) -> int:
        """One cadence tick: export the dirty delta, append it (plus any
        carried failures), compact when the log is long enough.  Returns
        items persisted.  Synchronous — call from an executor."""
        with self._write_lock:
            if not self._running:
                # A flush queued on the executor before close() landed
                # must not run after the final base / store close.
                return 0
            t0 = time.perf_counter()
            snap = self.engine.export_columns(dirty_only=True)
            items = snapshot_items(snap)
            batch = self._carry + ([snap] if items else [])
            self._carry = []
            written = 0
            for s in batch:
                try:
                    self.store.append_delta(s)
                except OSError as e:
                    # The engine's dirty set is already reset: losing
                    # this delta silently would break the loss bound.
                    # Carry it.
                    self._carry.append(s)
                    self.metric_write_failures += 1
                    log.warning(
                        "snapshot delta write failed (carried): %s", e
                    )
                    continue
                n = snapshot_items(s)
                written += n
                self.metric_delta_writes += 1
                self.metric_items_written += n
                self._observe("delta", time.perf_counter() - t0, n)
            if self.store.delta_records >= self.deltas_per_base:
                self._write_base_locked()
            return written

    def write_base(self) -> None:
        """Compaction / final-snapshot path: one FULL export becomes the
        next generation's base (carried deltas fold in for free — a full
        export supersedes every delta)."""
        with self._write_lock:
            self._write_base_locked()

    def _write_base_locked(self) -> None:
        t0 = time.perf_counter()
        snap = self.engine.export_columns(dirty_only=False)
        try:
            self.store.write_base(snap)
        except OSError as e:
            self.metric_write_failures += 1
            log.warning("snapshot base write failed: %s", e)
            return
        self._carry = []
        self.metric_base_writes += 1
        items = snapshot_items(snap)
        self.metric_items_written += items
        self._observe("base", time.perf_counter() - t0, items)

    async def close(self, final_base: bool = True) -> None:
        """Stop the loop, then (by default) write a final full base —
        the zero-loss half of graceful shutdown."""
        self._running = False
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        if final_base:
            await asyncio.get_running_loop().run_in_executor(
                None, self.write_base
            )
        self.store.close()
