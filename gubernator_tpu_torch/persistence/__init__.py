"""Crash-safe bucket-state persistence (docs/persistence.md).

Turns "restart = amnesia" into a bounded-loss guarantee: a checksummed,
atomically-written snapshot store (:class:`SnapshotStore` — base snapshot
+ append-only dirty-delta log + manifest, CRC per record, write-to-temp +
fsync + rename, periodic compaction) fed by a supervised background loop
(:class:`SnapshotWriter`) that drains ``export_columns(dirty_only=True)``
from the device table and the cold tier.  On startup the service loads
the base, replays deltas in order (corrupt/truncated tails are counted
and skipped, never fatal), TTL-expires stale rows, then serves.

Loss bounds: ≤ one ``GUBER_SNAPSHOT_INTERVAL`` of dirty state on a hard
kill; zero on graceful shutdown (close writes a final full base).

The port's copy of the JAX package's ``persistence/__init__.py``:
the same behavior and on-disk format, pure host code (numpy), with
plain ``threading`` locks.
"""

from gubernator_tpu_torch.persistence.snapshot import (
    RestoreResult,
    SnapshotStore,
    decode_snapshot,
    encode_snapshot,
    read_records,
    snapshot_items,
    write_record,
)
from gubernator_tpu_torch.persistence.transition import (
    TransitionLog,
    TransitionRecord,
    check_interrupted,
)
from gubernator_tpu_torch.persistence.writer import SnapshotWriter

__all__ = [
    "RestoreResult",
    "SnapshotStore",
    "SnapshotWriter",
    "TransitionLog",
    "TransitionRecord",
    "check_interrupted",
    "decode_snapshot",
    "encode_snapshot",
    "read_records",
    "snapshot_items",
    "write_record",
]
