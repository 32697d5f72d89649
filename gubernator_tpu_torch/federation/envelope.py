"""Federation envelope types: the inter-region exchange unit.

The port's copy of the JAX package's ``federation/envelope``.

An envelope carries per-key hit *deltas* from one origin node to the
owning peer of each key in one remote region, tagged with a per-channel
monotonic sequence number.  The merge discipline makes delivery safe
under every WAN failure mode the breaker path produces:

* **Commutative** — records are additive hit deltas; each (origin →
  target) channel numbers its envelopes independently, so envelopes from
  different origins apply in any interleaving and converge to the same
  totals.
* **Idempotent** — the receiver keeps the last applied sequence per
  channel (:class:`ReceiveLedger`); a redelivered envelope (``seq <=
  last``) is acked but not re-applied, so a retry after a lost ack (the
  one-way-partition case) never double-counts.  The channel identity is
  ``(origin, epoch)`` — the sender's advertise address *plus* a
  per-boot nonce — so a restarted sender (same address, seq back at 1)
  opens a fresh ledger entry instead of having its first envelopes
  swallowed as duplicates of the previous incarnation's sequences.

Exactly-once then falls out of the sender discipline in
:class:`~gubernator_tpu_torch.federation.manager.FederationManager`: at most
one envelope is in flight per channel, a failed send retries the *same*
envelope (same seq, same records) while new deltas merge into the
pending buffer for ``seq + 1`` — no hit is ever dropped or applied
twice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from gubernator_tpu_torch.types import Behavior, set_behavior


@dataclass
class FederationRecord:
    """One key's accumulated hit delta plus the limit config a remote
    region needs to create the bucket if it has never seen the key."""

    name: str = ""
    unique_key: str = ""
    hits: int = 0
    limit: int = 0
    duration: int = 0
    algorithm: int = 0
    behavior: int = 0
    burst: int = 0
    created_at: int = 0

    def hash_key(self) -> str:
        return self.name + "_" + self.unique_key

    def merge(self, other: "FederationRecord") -> None:
        """Fold another delta for the same key into this one: hits add
        (the commutative core), limit config takes the newer record's
        values (last-writer-wins, matching queue_update's dict
        overwrite), RESET_REMAINING ORs in like the intra-region hit
        aggregation."""
        self.hits += other.hits
        self.limit = other.limit
        self.duration = other.duration
        self.algorithm = other.algorithm
        if other.behavior & int(Behavior.RESET_REMAINING):
            self.behavior = set_behavior(
                self.behavior, Behavior.RESET_REMAINING, True)
        self.burst = other.burst
        self.created_at = other.created_at


@dataclass
class FederationEnvelope:
    """A batch of records on one (origin node → target peer) channel."""

    origin: str = ""   # sender's advertise address
    region: str = ""   # sender's datacenter (loop-prevention tag)
    epoch: str = ""    # sender's boot nonce; (origin, epoch) = channel id
    seq: int = 0       # per-channel monotonic sequence, starts at 1
    records: List[FederationRecord] = field(default_factory=list)


@dataclass
class FederationAck:
    """Receiver's reply: the highest sequence applied for the origin."""

    origin: str = ""
    seq: int = 0
    applied: int = 0   # records applied (0 for a duplicate no-op)


class ReceiveLedger:
    """Last-applied sequence per ``(origin, epoch)`` channel: the
    idempotency gate.

    The sender guarantees at most one outstanding envelope per channel
    and only advances ``seq`` after an ack, so on a healthy channel
    sequences arrive in order; ``seq <= last`` can only mean a
    redelivery of an envelope whose ack was lost — a no-op.

    Keying by epoch (the sender's per-boot nonce) is what makes that
    inference restart-safe: a rebooted sender reuses its advertise
    address but numbers a *fresh* stream from 1, and without the epoch
    every envelope of the new incarnation would compare ``<=`` the old
    ledger entry and be acked-but-dropped for as long as the previous
    uptime.  Dead epochs' entries are retained (one int per sender
    boot) so a straggler redelivery from the previous incarnation is
    still recognized as a duplicate."""

    def __init__(self):
        self._last: Dict[Tuple[str, str], int] = {}

    def seen(self, env: FederationEnvelope) -> bool:
        """True for a duplicate (ack ``seq`` again, apply nothing)."""
        return env.seq <= self._last.get((env.origin, env.epoch), 0)

    def mark(self, env: FederationEnvelope) -> None:
        """Record a successful apply.  Called *after* the apply lands, so
        an apply that fails mid-RPC leaves the sequence unmarked and the
        sender's retry of the same envelope is admitted, not dropped."""
        key = (env.origin, env.epoch)
        self._last[key] = max(env.seq, self._last.get(key, 0))

    def admit(self, env: FederationEnvelope) -> bool:
        """Check-and-mark in one step (the unit-fuzz convenience): True
        when the envelope is new, False for a duplicate."""
        if self.seen(env):
            return False
        self.mark(env)
        return True

    def last(self, origin: str, epoch: str = "") -> int:
        return self._last.get((origin, epoch), 0)


def merge_records(
    into: Dict[str, FederationRecord],
    records: List[FederationRecord],
    limit: int,
) -> Tuple[int, int]:
    """Fold ``records`` into the per-key map ``into``, bounded at
    ``limit`` *distinct keys* (merging bounds the key count, never the
    hits — an existing key always absorbs its delta, so a full buffer
    under sustained traffic still loses nothing for tracked keys).
    Returns (merged, dropped_new_keys)."""
    merged = dropped = 0
    for rec in records:
        k = rec.hash_key()
        prev = into.get(k)
        if prev is not None:
            prev.merge(rec)
            merged += 1
        elif len(into) < limit:
            into[k] = rec
            merged += 1
        else:
            dropped += 1
    return merged, dropped
