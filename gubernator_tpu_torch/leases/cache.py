"""Client-side lease cache: answer rate-limit checks locally while a
signed lease holds budget (the port's copy of the JAX package's
``leases/cache.py``; its lock is a plain ``threading.Lock``).

The cache is the client half of the cooperative tier (docs/leases.md):
it admits from the lease's delegated budget with zero server round
trips, and talks to the server only at the lease *edges* — grant,
exhaustion, expiry, release.  Its one hard invariant is **never
over-admit**: the local admit count under a lease can never exceed the
granted budget, under any failure — offline extension stretches a
lease's *time*, never its budget, so a partitioned client degrades to
denials, not to free admissions.

The core is a synchronous state machine over an injectable clock
(ManualClock-compatible: a callable returning float seconds), driven
either by the convenience :meth:`admit` (plain callables — tests, sync
clients) or by async glue that speaks the same primitives
(client.LeaseSession).  Sync/grant callables may raise — including
:class:`~gubernator_tpu_torch.resilience.BreakerOpenError` when the owner is
unreachable — and the cache answers from local state within the bounded
offline grace window instead of failing the caller.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, replace as _replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from gubernator_tpu_torch.leases.protocol import (
    LeaseCacheStats,
    LeaseSpec,
    LeaseSync,
    LeaseSyncAck,
    LeaseToken,
)

# try_admit verdicts.
ADMIT = "admit"          # consumed from the local lease
DENY = "deny"            # lease live but budget exhausted and un-renewable
NEED_LEASE = "need_lease"  # caller should grant/renew (sync rides along)


@dataclass
class _Record:
    token: LeaseToken
    remaining: int           # unconsumed local budget
    unsynced: int            # consumed since the last successful sync
    extensions: int = 0      # offline grace extensions applied
    limit: int = 0           # config the lease was granted under —
    duration: int = 0        # a change here means revoke-and-regrant


class LeaseCache:
    """Per-client cache of held leases with local budget accounting."""

    def __init__(
        self,
        grant_fn: Optional[Callable[..., Sequence[Optional[LeaseToken]]]] = None,
        sync_fn: Optional[Callable[..., Sequence[LeaseSyncAck]]] = None,
        *,
        clock: Callable[[], float] = time.time,
        verifier=None,
        want_budget: int = 0,
        offline_grace_ms: int = 5_000,
        max_offline_extensions: int = 3,
        holder_id: Optional[str] = None,
    ):
        self._grant_fn = grant_fn
        self._sync_fn = sync_fn
        self._clock = clock
        self._verifier = verifier
        # Leaseholder identity: the server accounts each holder's slice
        # separately (several clients may lease the same key), so every
        # outgoing spec/sync carries this cache's id.  Random per cache
        # by default — two caches must never collide on one identity.
        self.holder_id = holder_id or os.urandom(8).hex()
        self.want_budget = int(want_budget)
        self.offline_grace_ms = int(offline_grace_ms)
        self.max_offline_extensions = int(max_offline_extensions)
        self._records: Dict[Tuple[str, str], _Record] = {}
        self._lock = threading.Lock()
        self._closed = False
        self.metric_local_admits = 0
        self.metric_local_denies = 0
        self.metric_grants = 0
        self.metric_syncs = 0
        self.metric_offline_extensions = 0
        self.metric_sync_lost = 0

    # ------------------------------------------------------------------
    # State-machine primitives (lock-protected; async glue drives these)
    # ------------------------------------------------------------------
    def now_ms(self) -> int:
        return int(self._clock() * 1000)

    def try_admit(self, spec: LeaseSpec, hits: int = 1) -> str:
        """One local admission attempt.  ADMIT consumed ``hits`` from the
        lease; NEED_LEASE means the caller should run a grant round
        (collect :meth:`take_syncs` first) and retry; DENY is a local,
        budget-honest denial."""
        if self._closed:
            raise RuntimeError("lease cache is closed")
        k = (spec.name, spec.key)
        now = self.now_ms()
        with self._lock:
            rec = self._records.get(k)
            if rec is None:
                return NEED_LEASE
            if rec.limit != spec.limit or rec.duration != spec.duration:
                # Config changed under the lease: stop self-enforcing
                # against stale terms; the next grant round syncs what
                # was consumed and the server bumps the generation.
                return NEED_LEASE
            if rec.token.expires_ms <= now:
                return NEED_LEASE
            if rec.remaining >= hits:
                rec.remaining -= hits
                rec.unsynced += hits
                self.metric_local_admits += hits
                return ADMIT
            # Insufficient local budget: a grant round may top it up
            # (the caller denies if the retry still can't cover it).
            return NEED_LEASE

    def take_syncs(self, release: bool = False) -> List[LeaseSync]:
        """Snapshot every record's unsynced consumption as LeaseSync
        items (the consumed counts stay owned by the records until
        :meth:`note_synced` confirms delivery)."""
        out: List[LeaseSync] = []
        with self._lock:
            for (name, key), rec in self._records.items():
                if rec.unsynced > 0 or release:
                    out.append(LeaseSync(
                        name=name, key=key, consumed=rec.unsynced,
                        generation=rec.token.generation, release=release,
                        holder=self.holder_id,
                    ))
        return out

    def note_synced(self, syncs: Sequence[LeaseSync],
                    acks: Sequence[LeaseSyncAck]) -> None:
        """Confirm delivery: subtract the synced counts; a stale-
        generation ack drops the record (the lease was revoked)."""
        with self._lock:
            for s, a in zip(syncs, acks):
                rec = self._records.get((s.name, s.key))
                if rec is None:
                    continue
                rec.unsynced = max(0, rec.unsynced - s.consumed)
                self.metric_syncs += 1
                if not a.accepted or s.release:
                    self._records.pop((s.name, s.key), None)

    def note_grant(self, spec: LeaseSpec,
                   token: Optional[LeaseToken]) -> bool:
        """Install a grant-round result.  A None/zero-budget token means
        the server declined (bucket too hot to delegate) — the caller
        falls back to per-request server decisions.  Returns True when a
        usable lease is now held."""
        k = (spec.name, spec.key)
        with self._lock:
            if token is None or token.budget <= 0:
                self._records.pop(k, None)
                return False
            if self._verifier is not None and not self._verifier.verify(token):
                self._records.pop(k, None)
                return False
            old = self._records.get(k)
            carried = old.unsynced if old is not None else 0
            self._records[k] = _Record(
                token=token, remaining=token.budget, unsynced=carried,
                limit=spec.limit, duration=spec.duration,
            )
            self.metric_grants += 1
            return True

    def extend_offline(self, spec: LeaseSpec) -> bool:
        """The owner is unreachable (breaker open, RPC failure): push the
        held lease's expiry out by the offline grace window — bounded,
        time-only (remaining budget is NOT refreshed, so the no-over-
        admission invariant holds through any partition length).
        Returns False once the extension budget is spent."""
        k = (spec.name, spec.key)
        now = self.now_ms()
        with self._lock:
            rec = self._records.get(k)
            if rec is None or rec.extensions >= self.max_offline_extensions:
                return False
            rec.extensions += 1
            rec.token = rec.token.with_expiry(
                max(rec.token.expires_ms, now) + self.offline_grace_ms,
                rec.token.signature,
            )
            self.metric_offline_extensions += 1
            return True

    # ------------------------------------------------------------------
    # Convenience loop (sync callables; tests and sync clients)
    # ------------------------------------------------------------------
    def admit(self, spec: LeaseSpec, hits: int = 1) -> Optional[bool]:
        """Admit ``hits`` against ``spec`` locally.  True/False is a
        local verdict; None means "no lease path" — the caller should
        fall back to an ordinary server request (which is itself a
        correct, server-accounted decision)."""
        verdict = self.try_admit(spec, hits)
        if verdict == ADMIT:
            return True
        if verdict == DENY:
            self.metric_local_denies += hits
            return False
        # NEED_LEASE: one sync+grant round, then one retry.
        if self._grant_fn is None:
            return None
        syncs = self.take_syncs()
        try:
            if syncs and self._sync_fn is not None:
                self.note_synced(syncs, self._sync_fn(syncs))
            tokens = self._grant_fn([self.fill_want(spec)])
        except Exception:
            # Owner unreachable (BreakerOpenError, RPC failure): answer
            # from local state inside the bounded grace window.
            if self.extend_offline(spec):
                verdict = self.try_admit(spec, hits)
                if verdict == ADMIT:
                    return True
                self.metric_local_denies += hits
                return False
            return None
        held = self.note_grant(spec, tokens[0] if tokens else None)
        if not held:
            return None
        verdict = self.try_admit(spec, hits)
        if verdict == ADMIT:
            return True
        if verdict == DENY:
            self.metric_local_denies += hits
            return False
        # Fresh grant still can't cover ``hits`` (budget cap < batch):
        # not a lease-tier verdict — fall back to a server decision.
        return None

    def fill_want(self, spec: LeaseSpec) -> LeaseSpec:
        """Spec ready to send: this cache's budget ask and leaseholder
        identity filled in (the server accounts slices per holder)."""
        want = (
            self.want_budget if self.want_budget and not spec.want
            else spec.want
        )
        if want != spec.want or spec.holder != self.holder_id:
            return _replace(spec, want=want, holder=self.holder_id)
        return spec

    # ------------------------------------------------------------------
    # Shutdown drain
    # ------------------------------------------------------------------
    def mark_closed(self) -> bool:
        """Flip to closed; False when already closed (close is
        idempotent).  Split out so async callers (client.LeaseSession)
        can run the same drain shape with awaited sync calls."""
        if self._closed:
            return False
        self._closed = True
        return True

    def abandon_unsynced(self) -> int:
        """Drop every record, counting still-unsynced consumption into
        ``metric_sync_lost`` — the drain's last resort, never silent."""
        lost = 0
        with self._lock:
            for rec in self._records.values():
                lost += rec.unsynced
            self._records.clear()
        self.metric_sync_lost += lost
        return lost

    def close(self, deadline: Optional[float] = None,
              attempts: int = 2) -> int:
        """Flush every unsynced consumed count through the normal sync
        path, bounded and deadline-capped:
        up to ``attempts`` tries, each abandoned once ``deadline`` (on
        this cache's clock, seconds) passes.  Consumption that could not
        be delivered is counted in ``metric_sync_lost`` — never silently
        dropped.  Returns the number of admissions left unsynced."""
        if not self.mark_closed():
            return 0
        for _ in range(max(1, attempts)):
            if deadline is not None and self._clock() >= deadline:
                break
            syncs = self.take_syncs(release=True)
            if not syncs:
                break
            try:
                acks = self._sync_fn(syncs) if self._sync_fn else None
            except Exception:
                continue
            if acks is None:
                break
            self.note_synced(syncs, acks)
        return self.abandon_unsynced()

    # ------------------------------------------------------------------
    def stats(self) -> LeaseCacheStats:
        with self._lock:
            return LeaseCacheStats(
                leases=len(self._records),
                local_admits=self.metric_local_admits,
                local_denies=self.metric_local_denies,
                grants=self.metric_grants,
                syncs=self.metric_syncs,
                offline_extensions=self.metric_offline_extensions,
                sync_lost=self.metric_sync_lost,
                unsynced_consumed=sum(
                    r.unsynced for r in self._records.values()
                ),
                details={
                    f"{n}_{k}": {
                        "remaining": r.remaining,
                        "unsynced": r.unsynced,
                        "expires_ms": r.token.expires_ms,
                        "generation": r.token.generation,
                    }
                    for (n, k), r in self._records.items()
                },
            )
