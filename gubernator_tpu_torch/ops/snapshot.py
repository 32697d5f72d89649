"""The columnar snapshot that ``TickEngine`` exports and loads.

The port's copy of the reference's snapshot schema (the Loader v2 format,
``gubernator_tpu/ops/engine.py`` ``SNAP_FIELDS``, ``LEASE_SNAP_FIELDS``,
``ZOO_SNAP_FIELDS``) and of its dict helpers (``snapshot_from_items``,
``items_from_snapshot``, ``items_from_columns``).  A snapshot is a dict of
(n,) numpy columns, one entry an item, plus the keys as ``key_blob``
(bytes) and ``key_offsets`` ((n + 1,) int64).  ``SNAP_FIELDS`` are int64
except ``remaining_f`` (float64); the zoo and lease columns are extra int64
keys, absent from snapshots written before them and read as zeros.

:func:`columns_from_rows` and :func:`rows_from_columns` convert between
snapshot columns and the table's (k, 16) int64 rows (ops/buckets.py) on
the host, and :func:`item_rows` gives live rows the values their items
would load as; the rows cross to and from the card through the row
kernels (ops/rowtable.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from gubernator_tpu_torch.ops.buckets import ROW_W, WORD
from gubernator_tpu_torch.ops.reqcols import pack_blob

SNAP_FIELDS = (
    "algorithm", "limit", "remaining", "remaining_f", "duration",
    "created_at", "updated_at", "burst", "status", "expire_at",
)
# Quota-lease columns (outstanding budget, expiry, generation): kept
# beside the table, not in its rows, and exported as extra keys so that
# outstanding delegations survive a restore.
LEASE_SNAP_FIELDS = ("lease_budget", "lease_expire", "lease_gen")
# Algorithm-zoo state (GCRA's theoretical arrival time, the sliding
# window's previous count): in the rows, exported as extra keys.
ZOO_SNAP_FIELDS = ("tat", "prev_count")
ITEM_FIELDS = SNAP_FIELDS + ZOO_SNAP_FIELDS
# The narrow fields: the reference keeps them as int32 and exports their
# low byte.
_NARROW = ("algorithm", "status")


def _dtype(field: str):
    return np.float64 if field == "remaining_f" else np.int64


def empty_snapshot() -> dict:
    """A snapshot of no item, with every column the export writes."""
    return {"key_blob": b"", "key_offsets": np.zeros(1, np.int64),
            **{f: np.zeros(0, _dtype(f))
               for f in ITEM_FIELDS + LEASE_SNAP_FIELDS}}


def columns_from_rows(rows: np.ndarray) -> Dict[str, np.ndarray]:
    """(k, 16) int64 table rows → the snapshot's item columns: int64
    (the narrow fields' low byte, as the reference exports them) and
    ``remaining_f`` as float64."""
    cols = {f: rows[:, WORD[f]].copy() for f in ITEM_FIELDS}
    cols["remaining_f"] = cols["remaining_f"].view(np.float64)
    for f in _NARROW:
        cols[f] &= 0xFF
    return cols


def rows_from_columns(cols: Dict[str, np.ndarray], sel: np.ndarray
                      ) -> np.ndarray:
    """The table rows (in use) of snapshot items ``sel``: the narrow
    fields wrap to int32 as the reference stores them."""
    rows = np.zeros((len(sel), ROW_W), np.int64)
    for f in ITEM_FIELDS:
        v = np.asarray(cols[f])[sel]
        if f == "remaining_f":
            v = v.astype(np.float64).view(np.int64)
        elif f in _NARROW:
            v = v.astype(np.int64).astype(np.int32)
        rows[:, WORD[f]] = v
    rows[:, WORD["in_use"]] = 1
    return rows


def item_rows(rows: np.ndarray) -> np.ndarray:
    """Live table rows as their Loader items would load them
    (``rows_from_items`` of ``items_from_columns`` of
    ``columns_from_rows``), in place: the narrow fields keep their low
    byte, ``in_use`` is 1 and words 13-15 are 0; returns ``rows``."""
    for f in _NARROW:
        rows[:, WORD[f]] &= 0xFF
    rows[:, WORD["in_use"]] = 1
    rows[:, len(WORD):] = 0
    return rows


def rows_from_items(items: Sequence[dict]) -> np.ndarray:
    """The table rows (in use) of Loader-contract item dicts; items that
    do not name the zoo fields load them as zeros."""
    cols = {f: np.asarray([it.get(f, 0) if f in ZOO_SNAP_FIELDS else it[f]
                           for it in items], _dtype(f))
            for f in ITEM_FIELDS}
    return rows_from_columns(cols, np.arange(len(items)))


def snapshot_from_items(items: Sequence[dict]) -> dict:
    """Loader-contract item dicts → columnar snapshot (the inverse of
    :func:`items_from_snapshot`).  The zoo columns default to zero for
    items that do not name them."""
    blob, offsets = pack_blob([it["key"].encode() for it in items])
    snap: dict = {"key_blob": blob, "key_offsets": offsets}
    for f in SNAP_FIELDS:
        snap[f] = np.asarray([it[f] for it in items], _dtype(f))
    for f in ZOO_SNAP_FIELDS:
        snap[f] = np.asarray([it.get(f, 0) for it in items], np.int64)
    return snap


def items_from_snapshot(snap: dict) -> List[dict]:
    """Columnar snapshot → Loader-contract item dicts; absent zoo columns
    read as zeros."""
    offsets = snap["key_offsets"]
    blob = snap["key_blob"]
    n = len(offsets) - 1
    cols = {f: snap[f].tolist() if f in snap else [0] * n
            for f in ITEM_FIELDS}
    keys = [bytes(blob[offsets[j]:offsets[j + 1]]).decode()
            for j in range(n)]
    return [{"key": keys[j], **{f: cols[f][j] for f in ITEM_FIELDS}}
            for j in range(n)]


def items_from_columns(keys: List[bytes], cols: Dict[str, np.ndarray],
                       live: np.ndarray) -> List[dict]:
    """Loader-contract item dicts of slots ``live`` from host logical
    columns over every slot (``rowtable.host_columns``): ``keys[j]`` is
    slot ``live[j]``'s key."""
    picked = [np.asarray(cols[f])[live].astype(_dtype(f)).tolist()
              for f in ITEM_FIELDS]
    return [{"key": k.decode(), **dict(zip(ITEM_FIELDS, vals))}
            for k, vals in zip(keys, zip(*picked))]
