"""The native key→slot map, built from ``csrc/slotmap.cc`` at first use.

An open-addressing hash table (fnv1a, linear probing, tombstones) over a
fixed slot arena, with a batch API so one C call resolves a whole
window's keys.  Free slots hand out lowest first and released slots are
reused last-released first, so two maps fed the same calls assign the
same slots.  The same library holds :func:`crc32_batch`, the mesh
engine's key → shard router.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from gubernator_tpu_torch import _build

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_U32P = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_configured = False


def load_library() -> ctypes.CDLL:
    """The slot-map library with its C signatures set."""
    global _configured
    lib = _build.load("slotmap")
    if _configured:
        return lib
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.guber_slotmap_new.restype = vp
    lib.guber_slotmap_new.argtypes = [i64]
    lib.guber_slotmap_free.argtypes = [vp]
    lib.guber_slotmap_size.restype = i64
    lib.guber_slotmap_size.argtypes = [vp]
    lib.guber_slotmap_resolve_batch.argtypes = [
        vp, ctypes.c_char_p, _I64P, i64, _I64P, _U8P]
    lib.guber_slotmap_lookup_batch.argtypes = [
        vp, ctypes.c_char_p, _I64P, i64, _I64P]
    lib.guber_slotmap_assign_batch.argtypes = [
        vp, ctypes.c_char_p, _I64P, i64, _I64P]
    lib.guber_slotmap_mapped.argtypes = [vp, _U8P]
    lib.guber_slotmap_release_batch.argtypes = [vp, _I64P, i64]
    lib.guber_slotmap_keys_batch.restype = i64
    lib.guber_slotmap_keys_batch.argtypes = [
        vp, _I64P, i64, ctypes.c_char_p, i64, _I64P]
    lib.guber_crc32_batch.restype = None
    lib.guber_crc32_batch.argtypes = [ctypes.c_char_p, _I64P, i64, _U32P]
    _configured = True
    return lib


def as_char_p(blob):
    """A ``c_char_p``-compatible view of any bytes-like blob, copy-free for
    writable buffers; read-only non-bytes buffers fall back to one copy."""
    if isinstance(blob, (bytes, ctypes.Array)):
        return blob
    mv = memoryview(blob).cast("B")
    if mv.readonly:
        return mv.tobytes()
    return ctypes.cast(
        (ctypes.c_char * mv.nbytes).from_buffer(mv), ctypes.c_char_p
    )


def crc32_batch(blob, offsets: np.ndarray) -> np.ndarray:
    """zlib-compatible CRC-32 of every key of a packed (blob, offsets)
    pair, as (n,) uint32, in one native call."""
    lib = load_library()
    n = len(offsets) - 1
    offsets = np.ascontiguousarray(offsets, np.int64)
    out = np.empty(n, np.uint32)
    lib.guber_crc32_batch(as_char_p(blob), offsets, n, out)
    return out


class NativeSlotMap:
    """ctypes wrapper over the C++ slot map (same interface as
    ``ops.engine.SlotMap``)."""

    def __init__(self, capacity: int):
        self._lib = load_library()
        self.capacity = int(capacity)
        self._h = self._lib.guber_slotmap_new(self.capacity)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.guber_slotmap_free(h)
            self._h = None

    def __len__(self) -> int:
        return self._lib.guber_slotmap_size(self._h)

    def mapped_mask(self) -> np.ndarray:
        """Boolean array over slots: True where a key is assigned."""
        out = np.empty(self.capacity, np.uint8)
        self._lib.guber_slotmap_mapped(self._h, out)
        return out.astype(bool)

    def resolve_batch(self, keys: List[bytes]):
        """(slots, known) for a batch of keys in one native call; slot -1
        means the table is full for that key."""
        from gubernator_tpu_torch.ops.reqcols import pack_blob

        return self.resolve_blob(*pack_blob(keys))

    def resolve_blob(self, blob, offsets: np.ndarray):
        """resolve_batch on a pre-packed (blob, offsets) pair."""
        n = len(offsets) - 1
        offsets = np.ascontiguousarray(offsets, np.int64)
        slots = np.empty(n, np.int64)
        known = np.empty(n, np.uint8)
        self._lib.guber_slotmap_resolve_batch(
            self._h, as_char_p(blob), offsets, n, slots, known
        )
        return slots, known

    def lookup_blob(self, blob, offsets: np.ndarray) -> np.ndarray:
        """The slot of each key of a packed (blob, offsets) pair, -1 for a
        key that has none; nothing is assigned."""
        return self._batch(self._lib.guber_slotmap_lookup_batch, blob,
                           offsets)

    def assign_blob(self, blob, offsets: np.ndarray) -> np.ndarray:
        """The slot of each key, assigned when new; -1 where the table is
        full."""
        return self._batch(self._lib.guber_slotmap_assign_batch, blob,
                           offsets)

    def _batch(self, fn, blob, offsets: np.ndarray) -> np.ndarray:
        offsets = np.ascontiguousarray(offsets, np.int64)
        slots = np.empty(len(offsets) - 1, np.int64)
        fn(self._h, as_char_p(blob), offsets, len(slots), slots)
        return slots

    def release_batch(self, slots: np.ndarray) -> None:
        slots = np.ascontiguousarray(slots, np.int64)
        self._lib.guber_slotmap_release_batch(self._h, slots, len(slots))

    def keys_blob(self, slots: np.ndarray) -> tuple[bytes, np.ndarray]:
        """Keys of a batch of slots as one (blob, offsets) pair;
        unassigned slots span zero bytes."""
        slots = np.ascontiguousarray(slots, np.int64)
        n = len(slots)
        offsets = np.zeros(n + 1, np.int64)
        # The first call sizes the blob, the second fills it.
        need = self._lib.guber_slotmap_keys_batch(
            self._h, slots, n, None, 0, offsets)
        buf = ctypes.create_string_buffer(max(int(need), 1))
        self._lib.guber_slotmap_keys_batch(
            self._h, slots, n, buf, need, offsets)
        return buf.raw[: offsets[n]], offsets

    def keys_batch(self, slots: np.ndarray) -> List[bytes]:
        """Keys of a batch of slots (b"" for unassigned)."""
        blob, offsets = self.keys_blob(slots)
        mv = memoryview(blob)
        return [bytes(mv[offsets[i] : offsets[i + 1]]) for i in range(len(slots))]
