"""The ragged extent spec of the sharded serving table, and its layout
transitions.

Port of ``gubernator_tpu.parallel.partition``'s ``RaggedExtents``,
``LayoutTransition`` and ``plan_transition``.  The flat request matrix of
a mesh window carries GLOBAL slots in its slot row and is sorted by them,
and shard s owns global slots
``[s * local_capacity, (s + 1) * local_capacity)``, so each shard's lanes
form one contiguous extent of the window and the host's per-shard counts
compress to a cumulative ``(n_shards + 1,)`` offsets vector, which the
ragged tick (ops/raggedtick.py) walks on the device.

A :class:`LayoutTransition` is the one n -> m re-partitioning spec that a
reshard (``MeshTickEngine.reshard``) and every audit of it derive
ownership from.  The JAX module's ``relayout_block`` is the per-shard half
of a collective all-to-all over a device mesh, completed by a ``psum``
over the shard axis; on one card the shards are row ranges of one table
and a live slot's flat remap is the identity, so its counterpart here,
:func:`relayout_host`, places rows with the same ``g // cap_to``,
``g % cap_to`` rule on the host and needs no reduction.  The JAX module's
``ShardLayout`` and ``NodeLayout`` place arrays over a device mesh and
have no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class RaggedExtents:
    """How a resolved batch's per-shard lane counts become the offsets
    vector of one (n_shards, local_capacity) layout."""

    n_shards: int
    local_capacity: int

    def counts(self, sh: np.ndarray, ok: np.ndarray) -> np.ndarray:
        """Per-shard live lane counts of one resolved batch (``sh`` the
        per-request shard route, ``ok`` the live mask)."""
        if not ok.any():
            return np.zeros(self.n_shards, np.int64)
        return np.bincount(sh[ok], minlength=self.n_shards)

    def offsets(self, counts: np.ndarray) -> np.ndarray:
        """Cumulative extent offsets: shard s owns sorted lanes
        ``[offsets[s], offsets[s + 1])``.  Valid because the packed batch
        sorts by global slot, shards ascend with it, and error and padding
        lanes (the sentinel slot) sort past every extent."""
        off = np.zeros(self.n_shards + 1, np.int32)
        off[1:] = np.cumsum(counts)
        return off


@dataclass(frozen=True)
class LayoutTransition:
    """One n -> m re-partitioning of the slot space.

    Global slot ``g`` of the old layout is slot ``g`` of the new one; only
    the ownership boundaries move: its new owner is ``g // cap_to`` and
    its new local offset ``g % cap_to``.  ``live_slots`` is the number of
    slots that carry state (the old layout's capacity on a first
    transition); ``cap_to = ceil(live_slots / n_to)`` so every live slot
    fits, and threading ``live_slots`` through :meth:`then` makes
    n -> m -> n a round trip: 8 -> 3 -> 8 at cap 128 passes through cap
    342 and lands back at cap 128."""

    n_from: int
    cap_from: int
    n_to: int
    cap_to: int
    live_slots: int

    def owner_of(self, g):
        """New owning shard of global slot ``g`` (array or scalar)."""
        return g // self.cap_to

    def local_of(self, g):
        """New local offset of global slot ``g`` (array or scalar)."""
        return g % self.cap_to

    def old_owner_of(self, g):
        """Old owning shard of global slot ``g``."""
        return g // self.cap_from

    @property
    def capacity_to(self) -> int:
        return self.n_to * self.cap_to

    @property
    def capacity_from(self) -> int:
        return self.n_from * self.cap_from

    def then(self, n_next: int) -> "LayoutTransition":
        """The follow-up transition, ``live_slots`` carried so that round
        trips are exact."""
        return plan_transition(self.n_to, self.cap_to, n_next,
                               live_slots=self.live_slots)

    def remap(self) -> np.ndarray:
        """(live_slots, 3) audit table ``[new_shard, new_local, new_flat]``
        of every live global slot; ``new_flat`` is the identity."""
        g = np.arange(self.live_slots, dtype=np.int64)
        own = self.owner_of(g)
        loc = self.local_of(g)
        return np.stack([own, loc, own * self.cap_to + loc], axis=1)


def plan_transition(n_from: int, cap_from: int, n_to: int,
                    live_slots: int = None) -> LayoutTransition:
    """The :class:`LayoutTransition` of an n -> m reshard; ``live_slots``
    defaults to the old layout's capacity (pass the carried value when
    chaining, :meth:`LayoutTransition.then`)."""
    if n_from < 1 or n_to < 1:
        raise ValueError(f"shard counts must be >= 1; got {n_from}\u2192{n_to}")
    if cap_from < 1:
        raise ValueError(f"cap_from must be >= 1; got {cap_from}")
    live = n_from * cap_from if live_slots is None else int(live_slots)
    if not 0 < live <= n_from * cap_from:
        raise ValueError(
            f"live_slots {live} outside (0, {n_from * cap_from}]")
    cap_to = -(-live // n_to)  # ceil: every live slot keeps a home
    return LayoutTransition(n_from=int(n_from), cap_from=int(cap_from),
                            n_to=int(n_to), cap_to=int(cap_to),
                            live_slots=live)


def relayout_host(x: np.ndarray, shard: int,
                  tr: LayoutTransition) -> np.ndarray:
    """Old shard ``shard``'s (cap_from, ...) rows placed in a zeroed
    (n_to * cap_to, ...) buffer at ``owner_of(g) * cap_to + local_of(g)``
    (rows past the new capacity dropped).  The host counterpart of the JAX
    ``relayout_block``: the old shards' live slot ranges are disjoint, so
    summing their buffers (the JAX ``psum``) is their union, and one table
    on one card needs neither the sum nor the exchange."""
    g = shard * tr.cap_from + np.arange(tr.cap_from, dtype=np.int64)
    tgt = tr.owner_of(g) * tr.cap_to + tr.local_of(g)
    buf = np.zeros((tr.capacity_to,) + x.shape[1:], x.dtype)
    keep = tgt < tr.capacity_to
    buf[tgt[keep]] = x[keep]
    return buf
