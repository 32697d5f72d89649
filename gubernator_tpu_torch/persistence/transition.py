"""Crash-safe reshard transition record (docs/resharding.md).

The reshard coordinator journals the layout transition to an append-only
CRC-framed record file (same framing as the snapshot store) so a crash
mid-cutover lands in a *defined* state on restart:

* ``begin`` record written before any state moves;
* ``commit``/``abort`` record written once the transition reaches a
  terminal phase (new layout serving, or old layout restored).

On startup :func:`check_interrupted` reads the journal: a ``begin``
without a matching terminal record means the process died inside the
transition window — the restored snapshot (which the coordinator never
mutates mid-flight) is authoritative, the stale journal is cleared, and
the interruption is surfaced to metrics so operators see it.  A missing
or corrupt journal is never fatal: the torn tail is dropped exactly like
a torn delta record.

The port's copy of the JAX package's ``persistence/transition.py``:
the same behavior and on-disk format, pure host code (numpy), with
plain ``threading`` locks.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

from gubernator_tpu_torch.persistence.snapshot import read_records, write_record

TRANSITION_LOG = "reshard-transition.log"

PHASE_BEGIN = "begin"
PHASE_COMMIT = "commit"
PHASE_ABORT = "abort"
_TERMINAL = (PHASE_COMMIT, PHASE_ABORT)


@dataclass
class TransitionRecord:
    """One journal entry: the n→m transition and where it got to."""

    phase: str
    from_shards: int
    to_shards: int
    epoch: int

    def encode(self) -> bytes:
        return json.dumps({
            "phase": self.phase,
            "from": self.from_shards,
            "to": self.to_shards,
            "epoch": self.epoch,
        }, sort_keys=True).encode()

    @classmethod
    def decode(cls, payload: bytes) -> Optional["TransitionRecord"]:
        try:
            doc = json.loads(payload.decode())
            return cls(
                phase=str(doc["phase"]),
                from_shards=int(doc["from"]),
                to_shards=int(doc["to"]),
                epoch=int(doc["epoch"]),
            )
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            return None


class TransitionLog:
    """Append-only reshard journal under a persistence directory.

    ``dir_path=None`` (no persistence configured) degrades to a no-op
    journal — the coordinator still runs, it just cannot detect crashes
    across restarts.
    """

    def __init__(self, dir_path: Optional[str]):
        self.path = (
            os.path.join(dir_path, TRANSITION_LOG) if dir_path else None)

    def append(self, rec: TransitionRecord) -> None:
        if self.path is None:
            return
        with open(self.path, "ab") as f:
            write_record(f, rec.encode())
            f.flush()
            os.fsync(f.fileno())

    def records(self) -> list:
        if self.path is None:
            return []
        payloads, _corrupt = read_records(self.path)
        recs = [TransitionRecord.decode(p) for p in payloads]
        return [r for r in recs if r is not None]

    def clear(self) -> None:
        if self.path is None:
            return
        try:
            os.remove(self.path)
        except OSError:
            pass


def check_interrupted(log: TransitionLog) -> Optional[TransitionRecord]:
    """Startup check: the last ``begin`` with no terminal record after it
    (crash inside the transition window), else None.  Always clears the
    journal — records only matter across exactly one restart."""
    last_open: Optional[TransitionRecord] = None
    for rec in log.records():
        if rec.phase == PHASE_BEGIN:
            last_open = rec
        elif rec.phase in _TERMINAL:
            last_open = None
    log.clear()
    return last_open
