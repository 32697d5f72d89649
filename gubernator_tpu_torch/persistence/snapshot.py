"""Crash-safe columnar snapshot store: base + append-only deltas + manifest.

The durable layer under the engine's Loader-v2 columnar snapshots
(``engine.SNAP_FIELDS``; docs/persistence.md).  On disk, one snapshot
directory holds a *generation*: a full **base** snapshot, one append-only
**delta log** fed by ``export_columns(dirty_only=True)`` flushes, and a
**manifest** naming both.  Restore = load base, replay delta records in
append order (``load_columns`` applies them as upserts, last write wins),
TTL-expire stale rows (the engine's ``expire_at`` filter), serve.

Durability discipline:

* Every record — base and delta alike — is framed ``MAGIC | crc32 | len``
  with the CRC over the payload; a torn write is detected, never parsed.
* Base and manifest writes go write-to-temp → ``fsync`` → ``rename``
  (atomic on POSIX): a crash mid-write leaves the previous generation
  intact.  Delta appends ``flush`` + ``fsync`` before returning, so an
  acknowledged delta survives power loss.
* Replay **never raises** on bad data: a corrupt or truncated record
  stops that file's replay at the last good prefix and counts the damage
  (``corrupt_records``) — a half-written tail from a kill -9 costs at
  most the records after it, not the restore.
* Compaction (every ``deltas_per_base`` appended records) folds base +
  deltas into a fresh base under the NEXT generation number, then
  retires the old files — the old generation stays valid until the new
  manifest rename lands.
* A missing/corrupt manifest falls back to scanning the directory for
  the newest generation with a readable base — losing the manifest
  costs nothing but the scan.

The port's copy of the JAX package's ``persistence/snapshot.py``:
the same behavior and on-disk format, pure host code (numpy), with
plain ``threading`` locks.
"""

from __future__ import annotations

import io
import json
import logging
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger("gubernator.persistence")

MAGIC = b"GSNP"
_HEADER = struct.Struct("<4sIQ")  # magic, crc32(payload), payload length
MANIFEST = "MANIFEST.json"


def _base_name(gen: int) -> str:
    return f"base-{gen:08d}.snap"


def _delta_name(gen: int) -> str:
    return f"delta-{gen:08d}.log"


def _fsync_dir(path: str) -> None:
    """Durably record renames/creates in ``path`` (best-effort: not every
    filesystem supports directory fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def encode_snapshot(snap: dict) -> bytes:
    """Columnar snapshot dict → npz payload bytes (the ColumnFileLoader
    encoding: ``key_blob`` rides as a uint8 array)."""
    enc = dict(snap)
    enc["key_blob"] = np.frombuffer(
        bytes(snap["key_blob"]), np.uint8
    )
    buf = io.BytesIO()
    np.savez(buf, **enc)
    return buf.getvalue()


def decode_snapshot(payload: bytes) -> dict:
    """Inverse of :func:`encode_snapshot`."""
    with np.load(io.BytesIO(payload)) as z:
        snap = {k: z[k] for k in z.files}
    snap["key_blob"] = snap["key_blob"].tobytes()
    return snap


def snapshot_items(snap: dict) -> int:
    return max(0, len(snap["key_offsets"]) - 1)


def write_record(f, payload: bytes) -> int:
    """Append one CRC-framed record; returns bytes written (header incl.)."""
    header = _HEADER.pack(MAGIC, zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    f.write(header)
    f.write(payload)
    return len(header) + len(payload)


def read_records(path: str) -> Tuple[List[bytes], int]:
    """All valid record payloads from ``path``, stopping at the first
    corrupt or truncated record: ``(payloads, corrupt_records)``.  Never
    raises on bad data — a missing file is simply ``([], 0)``."""
    payloads: List[bytes] = []
    corrupt = 0
    try:
        f = open(path, "rb")
    except OSError:
        return payloads, corrupt
    with f:
        while True:
            header = f.read(_HEADER.size)
            if not header:
                break  # clean EOF
            if len(header) < _HEADER.size:
                corrupt += 1  # torn header (partial final write)
                break
            magic, crc, length = _HEADER.unpack(header)
            if magic != MAGIC:
                corrupt += 1  # framing lost; nothing after is trustworthy
                break
            payload = f.read(length)
            if len(payload) < length:
                corrupt += 1  # truncated tail
                break
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                corrupt += 1  # bit rot / torn payload
                break
            payloads.append(payload)
    return payloads, corrupt


@dataclass
class RestoreResult:
    """What a restore read: snapshots in replay order + damage counters."""

    snapshots: List[dict] = field(default_factory=list)
    generation: int = 0
    items: int = 0
    delta_records: int = 0
    corrupt_records: int = 0
    manifest_missing: bool = False


class SnapshotStore:
    """One snapshot directory (see module doc).  Not thread-safe by
    itself — the SnapshotWriter serializes all writers; restore runs
    before serving starts."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        # Adopt the newest on-disk generation immediately so a writer
        # that skips load() still appends to the log the manifest names
        # (not a phantom generation 0 that restore would never read).
        manifest = self._read_manifest()
        if manifest is not None:
            self.generation = int(manifest["generation"])
        else:
            gens = self._scan_generations()
            self.generation = gens[0] if gens else 0
        self.delta_records = 0   # records appended to the current log
        self._delta_f = None

    # ------------------------------------------------------------------
    # Restore
    # ------------------------------------------------------------------
    def _read_manifest(self) -> Optional[dict]:
        try:
            with open(os.path.join(self.dir, MANIFEST)) as f:
                m = json.load(f)
            if not isinstance(m.get("generation"), int):
                return None
            return m
        except (OSError, json.JSONDecodeError):
            return None

    def _scan_generations(self) -> List[int]:
        gens = set()
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        for name in names:
            # Delta logs count too: a fresh store's generation 0 has
            # deltas before its first compaction ever writes a base.
            for prefix, suffix in (("base-", ".snap"), ("delta-", ".log")):
                if name.startswith(prefix) and name.endswith(suffix):
                    try:
                        gens.add(int(name[len(prefix): -len(suffix)]))
                    except ValueError:
                        pass
        return sorted(gens, reverse=True)

    def load(self) -> RestoreResult:
        """Read the newest restorable generation: base first, then its
        delta records in append order.  Adopts that generation as the
        store's current one (subsequent appends continue its log)."""
        out = RestoreResult()
        manifest = self._read_manifest()
        candidates: List[int] = []
        if manifest is not None:
            candidates.append(int(manifest["generation"]))
        else:
            out.manifest_missing = True
        for g in self._scan_generations():
            if g not in candidates:
                candidates.append(g)
        for gen in candidates:
            base_path = os.path.join(self.dir, _base_name(gen))
            base_payloads, base_bad = read_records(base_path)
            delta_payloads, delta_bad = read_records(
                os.path.join(self.dir, _delta_name(gen))
            )
            snaps: List[dict] = []
            if base_payloads:
                try:
                    snaps.append(decode_snapshot(base_payloads[0]))
                except Exception:
                    base_bad += 1
                    base_payloads = []
            if not base_payloads:
                # No readable base.  Generation 0 legitimately has none
                # before its first compaction (deltas upsert onto an
                # empty table); any other generation only exists because
                # write_base completed, so a missing/corrupt base there
                # means rot — fall back to an older generation.
                if os.path.exists(base_path) or not delta_payloads:
                    out.corrupt_records += base_bad + delta_bad
                    continue
            out.corrupt_records += base_bad + delta_bad
            n_base = len(snaps)
            for p in delta_payloads:
                try:
                    snaps.append(decode_snapshot(p))
                except Exception:
                    # An undetected-by-CRC decode failure still must not
                    # kill the restore; everything before it stands.
                    out.corrupt_records += 1
                    break
            out.snapshots = snaps
            out.generation = gen
            out.delta_records = len(snaps) - n_base
            out.items = sum(snapshot_items(s) for s in snaps)
            self.generation = gen
            self.delta_records = out.delta_records
            return out
        return out  # empty directory (or nothing restorable): fresh start

    # ------------------------------------------------------------------
    # Write path
    # ------------------------------------------------------------------
    def _atomic_write(self, name: str, write_fn) -> None:
        path = os.path.join(self.dir, name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(self.dir)

    def _write_manifest(self) -> None:
        doc = json.dumps({
            "generation": self.generation,
            "base": _base_name(self.generation),
            "delta": _delta_name(self.generation),
        }).encode()
        self._atomic_write(MANIFEST, lambda f: f.write(doc))

    def append_delta(self, snap: dict) -> int:
        """Append one dirty-delta snapshot to the current generation's
        log (CRC record + fsync); returns records now in the log."""
        if self._delta_f is None:
            self._delta_f = open(
                os.path.join(self.dir, _delta_name(self.generation)), "ab"
            )
        write_record(self._delta_f, encode_snapshot(snap))
        self._delta_f.flush()
        os.fsync(self._delta_f.fileno())
        self.delta_records += 1
        return self.delta_records

    def write_base(self, snap: dict) -> int:
        """Start a new generation from a FULL snapshot: write its base
        atomically, reset the delta log, publish the manifest, retire the
        previous generation's files.  Returns the new generation."""
        old_gen = self.generation
        if self._delta_f is not None:
            self._delta_f.close()
            self._delta_f = None
        self.generation += 1
        payload = encode_snapshot(snap)
        self._atomic_write(
            _base_name(self.generation), lambda f: write_record(f, payload)
        )
        # Fresh (empty) delta log for the new generation — created before
        # the manifest names it so restore never chases a missing file.
        self._atomic_write(_delta_name(self.generation), lambda f: None)
        self.delta_records = 0
        self._write_manifest()
        # Old generation retires only after the new manifest landed: a
        # crash anywhere above restores the previous generation intact.
        for name in (_base_name(old_gen), _delta_name(old_gen)):
            try:
                os.unlink(os.path.join(self.dir, name))
            except OSError:
                pass
        return self.generation

    def close(self) -> None:
        if self._delta_f is not None:
            self._delta_f.close()
            self._delta_f = None
