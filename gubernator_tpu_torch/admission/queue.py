"""Bounded two-class admission queue (docs/overload.md).

Replaces the tick loop's unbounded pending list.  Two strict priority
classes: peer/GLOBAL reconcile traffic (class 0) outranks client
traffic (class 1) — under overload the mesh keeps converging while
client work degrades first, matching the reference's GLOBAL behavior
guarantees.  Overflow policy is deadline-ordered drop-oldest-expiring:
the queued *client* item whose deadline is soonest is shed first (it is
the work most likely to expire unserved anyway); only an all-peer
backlog sheds peer work.  The queue never sheds down to empty to admit
an oversized item — a single item larger than the whole limit is still
admitted when the queue is empty, so the bound can never deadlock a
legal batch.

Not thread-safe by itself: the tick loop serializes access under its
own condition lock.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Tuple

CLASS_PEER = 0
CLASS_CLIENT = 1


class QueueItem:
    """One queued submission: an object batch or a columnar batch plus
    its completion future, admission class, and absolute deadline."""

    __slots__ = ("kind", "payload", "n", "fut", "deadline", "klass", "seq")

    def __init__(self, kind, payload, n, fut, deadline=None,
                 klass=CLASS_CLIENT, seq=0):
        self.kind = kind
        self.payload = payload
        self.n = int(n)
        self.fut = fut
        self.deadline = deadline
        self.klass = klass
        self.seq = seq

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


class AdmissionQueue:
    """Bounded (in *requests*, not items) two-class FIFO-per-class
    queue with deadline-ordered overflow shedding."""

    def __init__(self, limit: int):
        self.limit = max(1, int(limit))
        self._classes: Tuple[Deque[QueueItem], Deque[QueueItem]] = (
            deque(), deque())
        self._requests = 0
        self._seq = 0

    @property
    def requests(self) -> int:
        """Total queued requests across both classes."""
        return self._requests

    def __len__(self) -> int:
        return len(self._classes[0]) + len(self._classes[1])

    def __bool__(self) -> bool:
        return self._requests > 0 or len(self) > 0

    def snapshot(self) -> dict:
        """Cheap public view for the control plane (sampled off the tick
        path; the tick loop's condition serializes access)."""
        return {
            "requests": self._requests,
            "items": len(self),
            "limit": self.limit,
        }

    def push(self, item: QueueItem) -> List[QueueItem]:
        """Admit ``item``, shedding queued work to stay under the bound.
        Returns the shed items (possibly including ``item`` itself when
        nothing lower-value can make room); the caller answers them."""
        self._seq += 1
        item.seq = self._seq
        shed: List[QueueItem] = []
        while self._requests > 0 and self._requests + item.n > self.limit:
            victim = self._pick_victim(item)
            if victim is None:
                # Nothing queued is lower-value than the incoming item:
                # shed the arrival itself.
                shed.append(item)
                return shed
            self._remove(victim)
            shed.append(victim)
        dq = self._classes[CLASS_PEER if item.klass == CLASS_PEER
                           else CLASS_CLIENT]
        dq.append(item)
        self._requests += item.n
        return shed

    def _pick_victim(self, incoming: QueueItem) -> Optional[QueueItem]:
        """Deadline-ordered drop-oldest-expiring: the queued client item
        with the soonest deadline (deadline-less items rank last within
        the class, oldest first).  Peer items are only victims when the
        incoming item is itself peer-class and no client work is queued
        — a client arrival never evicts reconcile traffic."""
        victim = self._soonest(self._classes[CLASS_CLIENT])
        if victim is not None:
            return victim
        if incoming.klass == CLASS_PEER:
            return self._soonest(self._classes[CLASS_PEER])
        return None

    @staticmethod
    def _soonest(dq: Deque[QueueItem]) -> Optional[QueueItem]:
        victim: Optional[QueueItem] = None
        for it in dq:
            if victim is None:
                victim = it
                continue
            vd = victim.deadline
            d = it.deadline
            if d is not None and (vd is None or d < vd):
                victim = it
        return victim

    def _remove(self, item: QueueItem) -> None:
        for dq in self._classes:
            try:
                dq.remove(item)
            except ValueError:
                continue
            self._requests -= item.n
            return

    def pop_window(self, max_requests: int) -> List[QueueItem]:
        """Take the next serving window: peer class drains first, then
        client, up to ``max_requests`` — but always at least one item so
        an oversized batch cannot wedge the loop."""
        out: List[QueueItem] = []
        total = 0
        for dq in self._classes:
            while dq:
                item = dq[0]
                if out and total + item.n > max_requests:
                    return out
                dq.popleft()
                self._requests -= item.n
                out.append(item)
                total += item.n
        return out

    def drain(self) -> List[QueueItem]:
        """Remove and return everything queued (shutdown path)."""
        out: List[QueueItem] = []
        for dq in self._classes:
            out.extend(dq)
            dq.clear()
        self._requests = 0
        return out
