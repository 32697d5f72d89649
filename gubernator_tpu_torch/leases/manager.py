"""Server-side lease mint: batched grants, reconciles, revocation (the
port's copy of the JAX package's ``leases/manager.py``, over the port's
engines; its lock is a plain ``threading.Lock``).

The manager turns lease traffic into the engine's native currency —
batched decisions and one on-device column window per call:

* **Grant** — delegating ``budget`` admissions IS a decision with
  ``hits=budget`` through the ordinary tick path (UNDER_LIMIT → the
  whole slice is charged up front and delegated; OVER_LIMIT → grant 0
  and the client falls back to per-request decisions).  Total
  admissions therefore never exceed server-side decisions plus granted
  budgets: the over-admission invariant is structural, not policed.
* **Reconcile** — a sync's unused budget flows back through the same
  decision path as *negative* hits (bucket_transition credits tokens
  for negative hits), so credit-back needs no new kernel either.
* **Per-holder slices** — several clients may hold leases on the same
  key concurrently, so a key's record carries one slice per leaseholder
  (LeaseSpec/LeaseSync.holder): a sync credits back only the syncing
  holder's unused slice, and cheap extension re-signs only the
  requesting holder's budget — no holder can ever consume or refund
  budget delegated to another.
* **Column accounting** — outstanding budget, lease expiry, and
  generation live as device columns parallel to the SoA table
  (engine.lease_window): one ``lease_apply`` launch (kernel B.9,
  ops/leasecols.py) per grant/sync window, no per-key host dispatch,
  exported/restored with the snapshot.  Columns mirror the per-key
  aggregate across holders.

Under overload (tick_loop.under_pressure) grants degrade to *cheap
extension*: re-sign the requesting holder's held budget with a
pushed-out TTL — zero device work, zero decisions — so the lease tier
sheds load exactly when the admission plane most needs it to
(docs/overload.md).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from gubernator_tpu_torch.admission import CLASS_PEER
from gubernator_tpu_torch.config import env_knob, parse_duration
from gubernator_tpu_torch.leases.protocol import (
    LeaseSpec,
    LeaseSync,
    LeaseSyncAck,
    LeaseToken,
)
from gubernator_tpu_torch.leases.signing import LeaseSigner
from gubernator_tpu_torch.types import RateLimitRequest, Status

log = logging.getLogger("gubernator.leases")


@dataclass
class LeaseConfig:
    """GUBER_LEASE_* knob surface (config.ENV_REGISTRY; example.conf)."""

    enabled: bool = True
    ttl_ms: int = 5_000            # GUBER_LEASE_TTL
    budget_fraction: float = 0.1   # GUBER_LEASE_BUDGET_FRACTION
    max_budget: int = 10_000       # GUBER_LEASE_MAX_BUDGET
    credit_back: bool = True       # GUBER_LEASE_CREDIT_BACK
    secret: bytes = b""            # GUBER_LEASE_SECRET

    @classmethod
    def from_env(cls) -> "LeaseConfig":
        def knob(name, default, parse):
            try:
                return env_knob(name, default, parse=parse)
            except ValueError:
                return default

        return cls(
            enabled=bool(knob("GUBER_LEASE_ENABLED", 1, int)),
            ttl_ms=int(
                knob("GUBER_LEASE_TTL", 5.0, parse_duration) * 1000),
            budget_fraction=knob("GUBER_LEASE_BUDGET_FRACTION", 0.1, float),
            max_budget=knob("GUBER_LEASE_MAX_BUDGET", 10_000, int),
            credit_back=bool(knob("GUBER_LEASE_CREDIT_BACK", 1, int)),
            secret=str(knob("GUBER_LEASE_SECRET", "", str)).encode(),
        )


@dataclass
class _Slice:
    """One leaseholder's live delegation on one key."""

    outstanding: int           # granted, not-yet-reconciled budget
    expires_ms: int


@dataclass
class _Held:
    """Host record of one key's live delegations (the signing/authority
    source of truth; the device columns mirror the per-key aggregate for
    batch accounting and snapshot survival).  ``holders`` keys slices by
    leaseholder identity so reconciles and extensions only ever touch
    the syncing client's own budget."""

    generation: int
    limit: int
    duration: int
    algorithm: int
    holders: Dict[str, _Slice] = field(default_factory=dict)

    @property
    def outstanding(self) -> int:
        return sum(s.outstanding for s in self.holders.values())

    @property
    def expires_ms(self) -> int:
        return max((s.expires_ms for s in self.holders.values()), default=0)


class LeaseManager:
    """Mints, renews, reconciles, and revokes quota leases.

    ``tick_loop=None`` runs decisions synchronously through
    ``engine.process`` (grant_local/sync_local — benches and
    ManualClock tests); with a tick loop, grants/syncs ride the
    ordinary admission queue (syncs in the peer class).
    """

    def __init__(
        self,
        engine,
        tick_loop=None,
        config: Optional[LeaseConfig] = None,
        metrics=None,
        signer: Optional[LeaseSigner] = None,
        clock=time.time,
    ):
        self.engine = engine
        self.tick_loop = tick_loop
        self.config = config or LeaseConfig.from_env()
        self.metrics = metrics
        self.signer = signer or LeaseSigner(secret=self.config.secret)
        self._clock = clock
        self._held: Dict[Tuple[str, str], _Held] = {}
        # Per-key generation high-water mark, surviving record removal:
        # a release pops the record, but a recreated record must NOT
        # restart at generation 1 or a partitioned client holding a
        # token from the earlier incarnation could sync against the new
        # one.  Generations are monotonic per key for the manager's
        # lifetime (and per process restart the random HMAC secret /
        # fresh ed25519 key already invalidates old tokens).
        self._gen_floor: Dict[Tuple[str, str], int] = {}
        self._lock = threading.Lock()
        # Plain-int counters (the tick-loop delta-sync pattern mirrors
        # engine counters; these sync straight into prometheus families
        # at increment time since lease traffic is not per-tick-window).
        self.metric_grants = 0
        self.metric_renewals = 0
        self.metric_revocations = 0
        self.metric_sync_loss = 0
        self.metric_sync_dropped = 0

    # ------------------------------------------------------------------
    # Public async surface (daemon path)
    # ------------------------------------------------------------------
    async def grant(
        self, specs: Sequence[LeaseSpec]
    ) -> List[Optional[LeaseToken]]:
        plan = self._plan_grants(specs)
        if plan.reqs:
            fut = self.tick_loop.submit(plan.reqs)
            responses = await asyncio.wrap_future(fut)
        else:
            responses = []
        return self._commit_grants(plan, responses)

    async def sync(
        self, syncs: Sequence[LeaseSync]
    ) -> List[LeaseSyncAck]:
        plan = self._plan_syncs(syncs)
        responses = []
        if plan.reqs:
            # Reconcile traffic rides the peer admission class: syncs
            # carry already-admitted consumption, so shedding them loses
            # accounting while shedding a client decision loses nothing.
            # _commit_syncs inspects the responses so that any shed or
            # unapplied reconcile is at least counted, never silent.
            fut = self.tick_loop.submit(plan.reqs, klass=CLASS_PEER)
            responses = await asyncio.wrap_future(fut)
        return self._commit_syncs(plan, responses)

    # ------------------------------------------------------------------
    # Synchronous surface (engine-only: benches, virtual-clock tests)
    # ------------------------------------------------------------------
    def grant_local(
        self, specs: Sequence[LeaseSpec], now_ms: Optional[int] = None
    ) -> List[Optional[LeaseToken]]:
        plan = self._plan_grants(specs, now_ms)
        responses = (
            self.engine.process(plan.reqs, now=now_ms) if plan.reqs else []
        )
        return self._commit_grants(plan, responses, now_ms)

    def sync_local(
        self, syncs: Sequence[LeaseSync], now_ms: Optional[int] = None
    ) -> List[LeaseSyncAck]:
        plan = self._plan_syncs(syncs, now_ms)
        responses = (
            self.engine.process(plan.reqs, now=now_ms) if plan.reqs else []
        )
        return self._commit_syncs(plan, responses, now_ms)

    # ------------------------------------------------------------------
    # Grant planning/commit
    # ------------------------------------------------------------------
    @dataclass
    class _GrantPlan:
        specs: List[LeaseSpec]
        reqs: List[RateLimitRequest]
        decide: List[int]          # spec index per request
        budgets: List[int]         # requested slice per request
        cheap: Dict[int, LeaseToken]   # spec index → extended token
        declined: Dict[int, None]      # spec index → lease tier off

    def _now_ms(self, now_ms: Optional[int] = None) -> int:
        return int(self._clock() * 1000) if now_ms is None else int(now_ms)

    def _budget_for(self, spec: LeaseSpec) -> int:
        cap = max(1, int(spec.limit * self.config.budget_fraction))
        cap = min(cap, self.config.max_budget, max(1, spec.limit))
        return min(spec.want, cap) if spec.want > 0 else cap

    def _plan_grants(self, specs, now_ms=None) -> "_GrantPlan":
        now = self._now_ms(now_ms)
        plan = self._GrantPlan(list(specs), [], [], [], {}, {})
        pressure = bool(
            self.tick_loop is not None
            and getattr(self.tick_loop, "under_pressure", lambda: False)()
        )
        with self._lock:
            for i, spec in enumerate(plan.specs):
                if not self.config.enabled:
                    plan.declined[i] = None
                    continue
                k = (spec.name, spec.key)
                rec = self._held.get(k)
                if rec is not None and (
                    rec.limit != spec.limit
                    or rec.duration != spec.duration
                ):
                    # Config changed: revoke the generation.  Every
                    # holder's outstanding stays charged until its sync
                    # reconciles it (a stale-generation sync is handled
                    # conservatively, never credited).
                    rec.generation += 1
                    rec.limit = spec.limit
                    rec.duration = spec.duration
                    rec.holders.clear()
                    self.metric_revocations += 1
                    if self.metrics is not None:
                        self.metrics.lease_revocations.inc()
                sl = (
                    rec.holders.get(spec.holder)
                    if rec is not None else None
                )
                if pressure and sl is not None and sl.outstanding > 0:
                    # Overload degrade (docs/overload.md): extend ONLY
                    # the requesting holder's held slice — no decision,
                    # no device work.  Another holder's budget is never
                    # re-minted here: with N holders on one key, each
                    # extension re-signs that client's own slice, so the
                    # sum of live token budgets never exceeds what was
                    # charged at grant time.
                    sl.expires_ms = now + self.config.ttl_ms
                    plan.cheap[i] = self.signer.mint(
                        spec.name, spec.key, sl.outstanding,
                        sl.expires_ms, rec.generation,
                    )
                    self.metric_renewals += 1
                    if self.metrics is not None:
                        self.metrics.lease_renewals.inc()
                    continue
                budget = self._budget_for(spec)
                plan.decide.append(i)
                plan.budgets.append(budget)
                plan.reqs.append(RateLimitRequest(
                    name=spec.name, unique_key=spec.key, hits=budget,
                    limit=spec.limit, duration=spec.duration,
                    algorithm=spec.algorithm, burst=spec.burst,
                ))
        return plan

    def _commit_grants(
        self, plan: "_GrantPlan", responses, now_ms=None
    ) -> List[Optional[LeaseToken]]:
        now = self._now_ms(now_ms)
        out: List[Optional[LeaseToken]] = [None] * len(plan.specs)
        granted_keys: List[bytes] = []
        granted_cols: List[Tuple[int, int, int]] = []
        with self._lock:
            for i, tok in plan.cheap.items():
                out[i] = tok
            for j, i in enumerate(plan.decide):
                spec = plan.specs[i]
                resp = responses[j]
                k = (spec.name, spec.key)
                rec = self._held.get(k)
                if resp.status != Status.UNDER_LIMIT or getattr(
                        resp, "error", ""):
                    # Bucket too hot to delegate, or the decision was
                    # shed with a retriable error (nothing was charged):
                    # no token — the client falls back to per-request
                    # decisions or retries the grant.
                    continue
                budget = plan.budgets[j]
                if rec is None:
                    # Recreated records continue from the per-key
                    # generation high-water mark, never restart at 1 —
                    # tokens from a released/revoked incarnation must
                    # stay stale forever.
                    rec = self._held[k] = _Held(
                        generation=self._gen_floor.get(k, 0) + 1,
                        limit=spec.limit, duration=spec.duration,
                        algorithm=spec.algorithm,
                    )
                sl = rec.holders.get(spec.holder)
                if sl is None:
                    sl = rec.holders[spec.holder] = _Slice(0, 0)
                sl.outstanding += budget
                sl.expires_ms = now + self.config.ttl_ms
                out[i] = self.signer.mint(
                    spec.name, spec.key, budget, sl.expires_ms,
                    rec.generation,
                )
                self.metric_grants += 1
                if self.metrics is not None:
                    self.metrics.lease_grants.inc()
                granted_keys.append(spec.full_key.encode())
                granted_cols.append(
                    (rec.outstanding, rec.expires_ms, rec.generation))
        self._apply_columns(granted_keys, granted_cols, is_set=True)
        return out

    # ------------------------------------------------------------------
    # Sync planning/commit
    # ------------------------------------------------------------------
    @dataclass
    class _SyncPlan:
        syncs: List[LeaseSync]
        reqs: List[RateLimitRequest]
        req_meta: List[Tuple[str, int]]   # ("credit"|"charge", amount)
        acks: List[LeaseSyncAck]
        col_keys: List[bytes]
        col_vals: List[Tuple[int, int, int]]

    def _plan_syncs(self, syncs, now_ms=None) -> "_SyncPlan":
        now = self._now_ms(now_ms)
        plan = self._SyncPlan(list(syncs), [], [], [], [], [])
        with self._lock:
            for s in plan.syncs:
                k = (s.name, s.key)
                rec = self._held.get(k)
                sl = rec.holders.get(s.holder) if rec is not None else None
                # A known key with a matching generation but no slice
                # for this holder is still stale: whatever this client
                # consumed was never delegated by the live record.
                stale = (
                    rec is None
                    or rec.generation != s.generation
                    or sl is None
                )
                consumed = max(s.consumed, 0)
                applied = 0 if stale else min(consumed, sl.outstanding)
                excess = consumed - applied
                credited = 0
                if not stale:
                    sl.outstanding -= applied
                    done = s.release or sl.expires_ms <= now
                    if done:
                        credited = (
                            sl.outstanding if self.config.credit_back else 0
                        )
                        unused = sl.outstanding
                        sl.outstanding = 0
                        # Only THIS holder's slice ends here — budget
                        # still delegated to other holders of the same
                        # key stays outstanding (their signed tokens
                        # remain live until their own sync/expiry).
                        rec.holders.pop(s.holder, None)
                        if s.release and not rec.holders:
                            self._held.pop(k, None)
                            self._gen_floor[k] = rec.generation
                        if credited > 0:
                            # Unused delegated budget flows back through
                            # the normal decision path: negative hits
                            # ADD tokens (ops/buckets.py) — no special
                            # kernel, full snapshot/GLOBAL semantics.
                            plan.reqs.append(RateLimitRequest(
                                name=s.name, unique_key=s.key,
                                hits=-credited,
                                limit=rec.limit, duration=rec.duration,
                                algorithm=rec.algorithm,
                            ))
                            plan.req_meta.append(("credit", credited))
                        elif unused:
                            pass  # credit-back disabled: stays charged
                charged = 0
                if excess > 0:
                    # Consumption beyond the grant (misbehaving or
                    # recovered client): count the over-admission, and
                    # force-charge it so the bucket reflects reality.
                    self.metric_sync_loss += excess
                    if self.metrics is not None:
                        self.metrics.lease_sync_loss.inc(excess)
                    if rec is not None:
                        # Stale generation ≠ unknown config: the record
                        # keeps the real (limit, duration), so the charge
                        # lands as an ordinary decision instead of a
                        # limit=0 config change that bucket_transition
                        # would clamp to the floor (ops/buckets.py).
                        plan.reqs.append(RateLimitRequest(
                            name=s.name, unique_key=s.key, hits=excess,
                            limit=rec.limit, duration=rec.duration,
                            algorithm=rec.algorithm,
                        ))
                        plan.req_meta.append(("charge", excess))
                        charged = excess
                    else:
                        # No config known for this key at all: a made-up
                        # limit would corrupt the bucket's config, so the
                        # excess is recorded as dropped accounting rather
                        # than charged.
                        self.metric_sync_dropped += excess
                        if self.metrics is not None:
                            self.metrics.lease_sync_dropped.inc(excess)
                if rec is not None:
                    ack_gen = rec.generation
                else:
                    ack_gen = max(
                        self._gen_floor.get(k, 0), s.generation) + 1
                plan.acks.append(LeaseSyncAck(
                    accepted=not stale,
                    generation=ack_gen,
                    credited=credited,
                    charged=charged,
                ))
                if not stale:
                    plan.col_keys.append(
                        f"{s.name}_{s.key}".encode())
                    plan.col_vals.append((
                        rec.outstanding, rec.expires_ms, rec.generation))
        return plan

    def _commit_syncs(self, plan: "_SyncPlan", responses=(),
                      now_ms=None) -> List[LeaseSyncAck]:
        # The host records were already mutated in _plan_syncs; if the
        # peer-class batch was shed (per-item retriable error) or a
        # force-charge bounced off the bucket floor (OVER_LIMIT consumes
        # nothing), the bucket never received the credit/charge.  That
        # drift cannot be rolled back safely — the ack may already be
        # promised — so it is counted and logged, never silent.
        dropped = 0
        for resp, (kind, amount) in zip(responses, plan.req_meta):
            if getattr(resp, "error", ""):
                dropped += amount
            elif kind == "charge" and resp.status != Status.UNDER_LIMIT:
                dropped += amount
        if dropped:
            self.metric_sync_dropped += dropped
            if self.metrics is not None:
                self.metrics.lease_sync_dropped.inc(dropped)
            log.warning(
                "lease reconcile lost %d admissions of bucket "
                "accounting (shed or unapplied credit/charge)", dropped)
        self._apply_columns(plan.col_keys, plan.col_vals, is_set=True)
        return plan.acks

    # ------------------------------------------------------------------
    # Device column window
    # ------------------------------------------------------------------
    def _apply_columns(self, keys: List[bytes],
                       vals: List[Tuple[int, int, int]],
                       is_set: bool) -> int:
        """One batched on-device lease-column update for this call's
        mutations — a single launch per window (engine.lease_window's
        exact-work counter proves it).  Engines without lease columns
        (the sharded mesh engine, as in the JAX package) skip the
        mirror; the host records above stay authoritative either way."""
        if not keys or not hasattr(self.engine, "lease_window"):
            return 0
        budgets = [v[0] for v in vals]
        expires = [v[1] for v in vals]
        gens = [v[2] for v in vals]
        return self.engine.lease_window(
            keys, budgets, expires, gens, is_set=is_set
        )

    # ------------------------------------------------------------------
    def revoke(self, name: str, key: str) -> bool:
        """Explicit revocation: bump the generation so every holder's
        outstanding tokens die at their next sync/renewal."""
        with self._lock:
            rec = self._held.get((name, key))
            if rec is None:
                return False
            rec.generation += 1
            rec.holders.clear()
            self.metric_revocations += 1
            if self.metrics is not None:
                self.metrics.lease_revocations.inc()
            return True

    def verifier(self):
        return self.signer.verifier()

    def outstanding(self, name: str, key: str) -> int:
        with self._lock:
            rec = self._held.get((name, key))
            return rec.outstanding if rec else 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "held": len(self._held),
                "holders": sum(
                    len(r.holders) for r in self._held.values()
                ),
                "grants": self.metric_grants,
                "renewals": self.metric_renewals,
                "revocations": self.metric_revocations,
                "sync_loss": self.metric_sync_loss,
                "sync_dropped": self.metric_sync_dropped,
                "outstanding_total": sum(
                    r.outstanding for r in self._held.values()
                ),
            }
