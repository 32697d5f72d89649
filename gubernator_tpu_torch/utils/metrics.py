"""Prometheus metrics with the reference's family names, in plain Python.

The port's copy of the JAX package's ``utils/metrics`` for the families a
node and its cluster feed (service, peer forwarding, GLOBAL reconcile,
breakers, cache, gRPC, tick, tiers, snapshots, admission, resharding and
the serving telemetry histograms).  It carries its own
small counter, gauge, summary and histogram families with ``labels()``
and renders the Prometheus text exposition the ``prometheus_client``
library would for the same families and calls (``_total`` counters,
``_created`` gauges, ``_count`` / ``_sum`` summaries, labels sorted by
name), so dashboards and scrapers see the same text.  Each daemon gets
its own :class:`Metrics`.
"""

from __future__ import annotations

import bisect
import math
import platform
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

def log_buckets(lo: float, hi: float, per_decade: int = 4) -> Tuple[float, ...]:
    """Fixed log-spaced bucket bounds from ``lo`` up to at least ``hi``."""
    step = 10.0 ** (1.0 / per_decade)
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * step)
    return tuple(round(b, 12) for b in out)


# 100 us ... ~56 s at 4 buckets a decade.
DEFAULT_BUCKETS = log_buckets(100e-6, 56.0)


def _float(v: float) -> str:
    """A sample value as Prometheus prints it (Go's float formatting)."""
    d = float(v)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _fmt_le(v: float) -> str:
    """Shortest float repr (the Prometheus ``le`` label convention)."""
    s = repr(float(v))
    return s[:-2] if s.endswith(".0") else s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _escape_doc(doc: str) -> str:
    return doc.replace("\\", r"\\").replace("\n", r"\n")


Sample = Tuple[str, Dict[str, str], float]


class _Child:
    """One label combination of a counter, gauge or summary."""

    __slots__ = ("value", "count", "created", "_lock")

    def __init__(self):
        self.value = 0.0   # counter / gauge value, summary sum
        self.count = 0.0   # summary observations
        self.created = time.time()
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only be incremented by "
                             "non-negative amounts")
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount

    def set(self, value: float) -> None:
        self.value = float(value)

    def observe(self, amount: float) -> None:
        with self._lock:
            self.count += 1.0
            self.value += amount


class _Family:
    """A metric family: children by label values, or one unlabelled."""

    kind = ""

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = (), registry=None):
        self.name = name
        self.doc = documentation
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = _Child()
        if registry is not None:
            registry.register(self)

    def labels(self, **labelvalues: str) -> _Child:
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, _Child())
        return child

    def _default(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name} has labels: call labels() first")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def observe(self, amount: float) -> None:
        self._default().observe(amount)

    def _labels(self, key) -> Dict[str, str]:
        return dict(zip(self.labelnames, key))

    def blocks(self) -> Iterator[Tuple[str, str, List[Sample]]]:
        """(name, type, samples) blocks as the text format prints them."""
        main: List[Sample] = []
        created: List[Sample] = []
        for key, c in list(self._children.items()):
            lab = self._labels(key)
            if self.kind == "counter":
                main.append((self.name + "_total", lab, c.value))
            elif self.kind == "gauge":
                main.append((self.name, lab, c.value))
            else:
                main.append((self.name + "_count", lab, c.count))
                main.append((self.name + "_sum", lab, c.value))
            if self.kind != "gauge":
                created.append((self.name + "_created", lab, c.created))
        head = self.name + "_total" if self.kind == "counter" else self.name
        yield head, self.kind, main
        if created:
            yield self.name + "_created", "gauge", created


class Counter(_Family):
    kind = "counter"


class Gauge(_Family):
    kind = "gauge"


class Summary(_Family):
    kind = "summary"


class _HistogramChild:
    """One label combination.  The observe path takes no lock: one
    ``list[i] += 1`` is serialized by the GIL."""

    __slots__ = ("_bounds", "_counts", "_sum")

    def __init__(self, bounds: Sequence[float]):
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self._sum = 0.0

    def observe(self, value: float) -> None:
        self._counts[bisect.bisect_left(self._bounds, value)] += 1
        self._sum += value


class Histogram:
    """Fixed log-spaced bucket histogram (reference ``utils/metrics.py:84``
    without the exemplars): ``_bucket`` / ``_count`` / ``_sum`` series."""

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = (), registry=None,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.doc = documentation
        self.labelnames = tuple(labelnames)
        self._bounds = tuple(buckets if buckets is not None
                             else DEFAULT_BUCKETS)
        if list(self._bounds) != sorted(self._bounds):
            raise ValueError("histogram buckets must be sorted")
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _HistogramChild] = {}
        if not self.labelnames:
            self._children[()] = _HistogramChild(self._bounds)
        if registry is not None:
            registry.register(self)

    def labels(self, **labelvalues: str) -> _HistogramChild:
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    key, _HistogramChild(self._bounds))
        return child

    def observe(self, value: float) -> None:
        if self.labelnames:
            raise ValueError(f"{self.name} needs labels(); has labelnames")
        self._children[()].observe(value)

    def blocks(self) -> Iterator[Tuple[str, str, List[Sample]]]:
        out: List[Sample] = []
        for key, child in list(self._children.items()):
            lab = dict(zip(self.labelnames, key))
            cum = 0
            counts = list(child._counts)
            for bound, n in zip(self._bounds, counts):
                cum += n
                out.append((self.name + "_bucket",
                            {**lab, "le": _fmt_le(bound)}, cum))
            cum += counts[-1]
            out.append((self.name + "_bucket", {**lab, "le": "+Inf"}, cum))
            out.append((self.name + "_count", lab, cum))
            out.append((self.name + "_sum", lab, child._sum))
        yield self.name, "histogram", out


class Registry:
    """The families of one daemon, in registration order."""

    def __init__(self):
        self.families: list = []

    def register(self, family) -> None:
        self.families.append(family)

    def blocks(self):
        for fam in self.families:
            for name, kind, samples in fam.blocks():
                yield fam, name, kind, samples

    def expose(self) -> bytes:
        out = []
        for fam, name, kind, samples in self.blocks():
            out.append(f"# HELP {name} {_escape_doc(fam.doc)}\n")
            out.append(f"# TYPE {name} {kind}\n")
            for sname, labels, value in samples:
                lab = ",".join(f'{k}="{_escape_label(v)}"'
                               for k, v in sorted(labels.items()))
                lab = f"{{{lab}}}" if lab else ""
                out.append(f"{sname}{lab} {_float(value)}\n")
        return "".join(out).encode()

    def get_sample_value(self, name: str,
                         labels: Dict[str, str]) -> Optional[float]:
        for _, _, _, samples in self.blocks():
            for sname, lab, value in samples:
                if sname == name and lab == labels:
                    return float(value)
        return None


class Metrics:
    """Per-daemon metric registry (names match the reference catalog)."""

    def __init__(self):
        self.registry = Registry()
        reg = self.registry
        from gubernator_tpu_torch.version import VERSION

        self.build_info = Gauge(
            "gubernator_build_info",
            "Build/version stamp; value is always 1.",
            ["version", "python", "machine"], registry=reg)
        self.build_info.labels(
            version=VERSION, python=platform.python_version(),
            machine=platform.machine()).set(1)

        # gubernator.go:60-111 service families.
        self.getratelimit_counter = Counter(
            "gubernator_getratelimit_counter",
            "The count of getLocalRateLimit() calls. Label \"calltype\" may "
            "be \"local\" for calls handled by the same peer, \"forward\" for "
            "calls forwarded to another peer, or \"global\" for global rate limits.",
            ["calltype"], registry=reg)
        self.func_duration = Summary(
            "gubernator_func_duration",
            "The timings of key functions in Gubernator in seconds.",
            ["name"], registry=reg)
        self.over_limit_counter = Counter(
            "gubernator_over_limit_counter",
            "The number of rate limit checks that are over the limit.",
            registry=reg)
        self.concurrent_checks = Gauge(
            "gubernator_concurrent_checks_counter",
            "The number of concurrent GetRateLimits API calls.",
            registry=reg)
        self.check_error_counter = Counter(
            "gubernator_check_error_counter",
            "The number of errors while checking rate limits.",
            ["error"], registry=reg)
        self.command_counter = Counter(
            "gubernator_command_counter",
            "The count of commands processed by each worker in WorkerPool.",
            ["worker", "method"], registry=reg)
        self.worker_queue_length = Gauge(
            "gubernator_worker_queue_length",
            "The count of requests queued up in WorkerPool.",
            ["method", "worker"], registry=reg)

        # Batch-forwarding families (gubernator.go:95-110).
        self.batch_send_duration = Summary(
            "gubernator_batch_send_duration",
            "The timings of batch send operations to a remote peer.",
            ["peerAddr"], registry=reg)
        self.batch_send_retries = Counter(
            "gubernator_batch_send_retries",
            "The count of retries occurred in asyncRequest() forwarding a "
            "request to another peer.",
            registry=reg)
        self.batch_queue_length = Gauge(
            "gubernator_batch_queue_length",
            "The getRateLimitsBatch() queue length in PeerClient.",
            ["peerAddr"], registry=reg)

        # GLOBAL manager families (global.go:50-67).
        self.global_send_duration = Summary(
            "gubernator_global_send_duration",
            "The duration of GLOBAL async sends in seconds.",
            registry=reg)
        self.broadcast_duration = Summary(
            "gubernator_broadcast_duration",
            "The duration of GLOBAL broadcasts to peers in seconds.",
            registry=reg)
        self.global_send_queue_length = Gauge(
            "gubernator_global_send_queue_length",
            "The count of requests queued up for global broadcast.",
            registry=reg)
        self.global_queue_length = Gauge(
            "gubernator_global_queue_length",
            "The count of requests queued up for update all peers.",
            registry=reg)

        # Cache families (lrucache.go:48-59).
        self.cache_size = Gauge(
            "gubernator_cache_size",
            "The number of items in LRU Cache which holds the rate limits.",
            registry=reg)
        self.cache_access_count = Counter(
            "gubernator_cache_access_count",
            "Cache access counts. Label \"type\" = \"miss\" or \"hit\".",
            ["type"], registry=reg)
        self.unexpired_evictions = Counter(
            "gubernator_unexpired_evictions_count",
            "Count the number of cache items which were evicted while "
            "unexpired.",
            registry=reg)

        # gRPC stats families (grpc_stats.go:41-121).
        self.grpc_request_counts = Counter(
            "gubernator_grpc_request_counts",
            "The count of gRPC requests.",
            ["status", "method"], registry=reg)
        self.grpc_request_duration = Summary(
            "gubernator_grpc_request_duration",
            "The timings of gRPC requests in seconds.",
            ["method"], registry=reg)

        # Device tick telemetry.
        self.tick_duration = Summary(
            "gubernator_tpu_tick_duration",
            "Wall time of one device tick (H2D + kernel + D2H) in seconds.",
            registry=reg)
        self.tick_batch_size = Summary(
            "gubernator_tpu_tick_batch_size",
            "Requests applied per device tick.",
            registry=reg)
        self.algorithm_requests = Counter(
            "gubernator_tpu_algorithm_requests",
            "Rate-limit items accepted for ticking, by algorithm.",
            ["algorithm"], registry=reg)
        # GLOBAL mesh reconcile telemetry: steps this daemon drove, the
        # reconcile programs those steps dispatched, and dense-fallback
        # steps.  One dispatch a step is the normal case; 2 means an
        # envelope overflow ran the dense fallback, so a sustained ratio
        # near 2.0 means the sparse envelope is too small for the traffic.
        self.mesh_reconcile_count = Counter(
            "gubernator_tpu_mesh_reconcile_count",
            "GLOBAL mesh reconcile steps driven by this daemon.",
            registry=reg)
        self.mesh_reconcile_dispatches = Counter(
            "gubernator_tpu_mesh_reconcile_dispatches",
            "Jitted mesh programs launched by this daemon's reconcile "
            "steps (1 per fused sparse or dense step; +1 when an "
            "envelope overflow runs the dense fallback).",
            registry=reg)
        self.mesh_dense_fallbacks = Counter(
            "gubernator_tpu_mesh_dense_fallbacks",
            "Sparse reconcile steps that overflowed the envelope and "
            "fell back to the dense program.",
            registry=reg)
        self.mesh_routed_windows = Counter(
            "gubernator_tpu_mesh_routed_windows",
            "Serving windows dispatched through the ragged flat tick "
            "(each shard walks its own extent of the slot-sorted "
            "batch on device).",
            registry=reg)
        self.mesh_routed_overflows = Counter(
            "gubernator_tpu_mesh_routed_overflows",
            "Pinned-zero canary: the retired routed path's skew "
            "fallback count. The ragged dispatch has no per-shard "
            "width, so any increment is a bug.",
            registry=reg)

        # Tiered bucket state (docs/tiering.md).
        self.cold_demotions = Counter(
            "gubernator_tpu_cold_demotions",
            "Bucket rows demoted from the device table into the "
            "host-side cold store (readback-then-evict).",
            registry=reg)
        self.cold_promotions = Counter(
            "gubernator_tpu_cold_promotions",
            "Bucket rows promoted from the cold store back into the "
            "device table (batched restore scatter on the miss path).",
            registry=reg)
        self.cold_hits = Counter(
            "gubernator_tpu_cold_hits",
            "Cache misses that found their bucket in the cold store.",
            registry=reg)
        self.cold_size = Gauge(
            "gubernator_tpu_cold_size",
            "The number of entries currently held by the cold store.",
            registry=reg)
        self.ssd_demotions = Counter(
            "gubernator_tpu_ssd_demotions",
            "Bucket rows demoted from the cold store into the SSD slab "
            "store (batched write-behind on cold-tier overflow).",
            registry=reg)
        self.ssd_promotions = Counter(
            "gubernator_tpu_ssd_promotions",
            "Bucket rows promoted from the SSD slab store back up the "
            "tiers (one batched lookup per miss tick).",
            registry=reg)
        self.ssd_hits = Counter(
            "gubernator_tpu_ssd_hits",
            "Miss-path SSD lookups that found their bucket in a slab.",
            registry=reg)
        self.ssd_compactions = Counter(
            "gubernator_tpu_ssd_compactions",
            "Log-structured compaction rounds (a sealed slab's live "
            "rows rewritten forward, the file retired).",
            registry=reg)
        self.ssd_bytes = Gauge(
            "gubernator_tpu_ssd_bytes",
            "Bytes currently held across SSD slab files.",
            registry=reg)
        self.ssd_queue_depth = Gauge(
            "gubernator_tpu_ssd_queue_depth",
            "Demote batches waiting on the SSD writer queue (at the "
            "configured depth, demote sweeps block — backpressure).",
            registry=reg)
        self.hot_occupancy = Gauge(
            "gubernator_tpu_hot_occupancy",
            "Fraction of device bucket-table slots holding a mapped key "
            "(0.0-1.0).",
            registry=reg)
        self.h2d_overlap_ratio = Gauge(
            "gubernator_tpu_h2d_overlap_ratio",
            "Fraction of serving windows whose request upload was "
            "dispatched while an earlier window's tick was still "
            "unresolved (0.0 serial, ~1.0 pipelined steady state).",
            registry=reg)
        self.shed_requests = Counter(
            "gubernator_tpu_shed_requests",
            "Requests answered with a per-item 'table full' error "
            "because the table was full and eviction freed nothing "
            "(the rest of their batch was still served).",
            registry=reg)

        # The fault-tolerant peer path (docs/resilience.md).
        self.breaker_state = Gauge(
            "gubernator_breaker_state",
            "Circuit breaker state per peer: 0=closed, 1=half-open, 2=open.",
            ["peerAddr"], registry=reg)
        self.breaker_transitions = Counter(
            "gubernator_breaker_transitions",
            "Circuit breaker state transitions per peer; label \"to\" is "
            "the state entered (closed/half_open/open).",
            ["peerAddr", "to"], registry=reg)
        self.degraded_answers = Counter(
            "gubernator_degraded_answers",
            "GLOBAL requests answered from local non-owner state while "
            "the owning peer's circuit breaker was open (degraded mode).",
            registry=reg)
        self.global_redelivered_hits = Counter(
            "gubernator_global_redelivered_hits",
            "GLOBAL hit records re-enqueued into the redelivery buffer "
            "after a failed flush to the owning peer.",
            registry=reg)
        self.global_dropped_hits = Counter(
            "gubernator_global_dropped_hits",
            "GLOBAL hit records dropped because the redelivery buffer "
            "was at its cap (GUBER_REDELIVERY_LIMIT) — lost accounting.",
            registry=reg)
        self.global_redelivered_broadcasts = Counter(
            "gubernator_global_redelivered_broadcasts",
            "GLOBAL update records re-enqueued for broadcast after a "
            "failed push to one or more peers.",
            registry=reg)
        self.global_dropped_broadcasts = Counter(
            "gubernator_global_dropped_broadcasts",
            "GLOBAL update records dropped because the broadcast "
            "redelivery buffer was at its cap.",
            registry=reg)

        # Crash-safe persistence (docs/persistence.md).
        self.snapshot_writes = Counter(
            "gubernator_tpu_snapshot_writes",
            "Snapshot records durably written; label \"kind\" is \"delta\" "
            "(incremental dirty export) or \"base\" (full compaction / "
            "final shutdown snapshot).",
            ["kind"], registry=reg)
        self.snapshot_items = Counter(
            "gubernator_tpu_snapshot_items",
            "Bucket rows carried by durably written snapshot records, "
            "by record kind.",
            ["kind"], registry=reg)
        self.snapshot_duration = Summary(
            "gubernator_tpu_snapshot_duration",
            "Wall time of one snapshot write (engine export + encode + "
            "fsync) in seconds, by record kind.",
            ["kind"], registry=reg)
        self.snapshot_corrupt_records = Counter(
            "gubernator_tpu_snapshot_corrupt_records",
            "Corrupt or truncated snapshot records skipped during "
            "startup restore (replay stops at the last good prefix; "
            "the service still starts).",
            registry=reg)
        self.snapshot_restored_items = Counter(
            "gubernator_tpu_snapshot_restored_items",
            "Bucket rows replayed from the snapshot store at startup "
            "(before TTL expiry filtering).",
            registry=reg)
        self.ownership_transfers = Counter(
            "gubernator_tpu_ownership_transfers",
            "GLOBAL keys whose accumulated state was handed to a new "
            "owning peer after a ring change; label \"result\" is "
            "\"pushed\" (landed on the new owner), \"requeued\" (push "
            "failed; retried via the broadcast redelivery buffer), or "
            "\"untracked\" (tracker at GUBER_REDELIVERY_LIMIT when the "
            "key updated — its state will not ride a handoff).",
            ["result"], registry=reg)
        # Live resharding (parallel/reshard.py): transition outcomes, the
        # running transition's phase, the serving shard count, the verify
        # phase's damage counters and the transition wall time.
        self.reshard_transitions = Counter(
            "gubernator_tpu_reshard_transitions",
            "Reshard transitions by terminal outcome: \"committed\" (new "
            "layout serving), \"aborted\" (rolled back to the old "
            "layout), \"interrupted\" (a begin record with no terminal "
            "record found at startup — the process died mid-transition "
            "and restarted on the last snapshot).",
            ["result"], registry=reg)
        self.reshard_phase = Gauge(
            "gubernator_tpu_reshard_phase",
            "Current reshard protocol phase: 0=idle, 1=freeze, 2=drain, "
            "3=relayout, 4=cutover, 5=verify (returns to 0 on commit or "
            "abort).",
            registry=reg)
        self.reshard_shards = Gauge(
            "gubernator_tpu_reshard_shards",
            "Serving shard count after the most recent committed "
            "transition (the engine's live mesh width).",
            registry=reg)
        self.reshard_state_loss = Counter(
            "gubernator_tpu_reshard_state_loss",
            "Bucket rows live before a transition but missing from the "
            "post-cutover table (verify phase). Must stay 0; gated at "
            "ABSOLUTE_ZERO by the reshard_live bench rung.",
            registry=reg)
        self.reshard_double_served = Counter(
            "gubernator_tpu_reshard_double_served",
            "Keys resident on more than one shard after a cutover "
            "(verify phase) — each is a potential double-serve. Must "
            "stay 0; gated at ABSOLUTE_ZERO by the reshard_live rung.",
            registry=reg)
        self.reshard_duration = Summary(
            "gubernator_tpu_reshard_duration",
            "Wall time of one reshard transition (freeze through verify) "
            "in seconds, by terminal outcome.",
            ["result"], registry=reg)
        # Multi-region federation (federation/): envelope traffic,
        # redelivery attempts, worst-case cross-region drift age, and
        # MULTI_REGION answers served while a peer region was down.
        self.federation_envelopes = Counter(
            "gubernator_tpu_federation_envelopes",
            "Federation envelopes by outcome: \"sent\" (acked by the "
            "remote owning peer), \"applied\" (received from a peer "
            "region and applied locally), \"duplicate\" (received again "
            "after a lost ack; acked without re-applying).",
            ["result"], registry=reg)
        self.federation_redeliveries = Counter(
            "gubernator_tpu_federation_redeliveries",
            "Federation envelope send attempts that failed (breaker "
            "open, RPC error, malformed ack) and will retry the same "
            "envelope after a jittered backoff.",
            registry=reg)
        self.federation_staleness = Gauge(
            "gubernator_tpu_federation_staleness_seconds",
            "Age of the oldest cross-region hit delta not yet acked by "
            "its target region (pending or in flight); the live bound "
            "on inter-region over-admission drift.",
            registry=reg)
        self.federation_degraded_answers = Counter(
            "gubernator_tpu_federation_degraded_answers",
            "MULTI_REGION requests answered from region-local state "
            "while at least one peer region was unreachable (its "
            "channel failing or breaker open) — each may over-admit up "
            "to the staleness budget.",
            registry=reg)
        # The shard autoscaler (autoscale/): every control decision,
        # every actuated transition, and every guardrail veto by name.
        self.autoscale_decisions = Counter(
            "gubernator_tpu_autoscale_decisions",
            "Autoscaler control decisions by action: \"act\" (a "
            "transition was actuated, or would have been in dry-run), "
            "\"hold\" (no sustained pressure / already at a bound), "
            "\"veto\" (a guardrail blocked an otherwise-justified "
            "transition).",
            ["action"], registry=reg)
        self.autoscale_transitions = Counter(
            "gubernator_tpu_autoscale_transitions",
            "Committed shard transitions actuated by the autoscaler, by "
            "direction (\"up\"/\"down\"); dry-run decisions and aborted "
            "transitions are not counted here.",
            ["direction"], registry=reg)
        self.autoscale_vetoes = Counter(
            "gubernator_tpu_autoscale_vetoes",
            "Autoscaler decisions blocked by a guardrail, by reason: "
            "breaker_open, reshard_busy, cooldown_up, cooldown_down, "
            "flap_cap, reshard_error.",
            ["reason"], registry=reg)
        self.loop_restarts = Counter(
            "gubernator_loop_restarts",
            "Background loops (global_hits, global_broadcast, peer_batch) "
            "restarted by their crash supervisor after an unexpected "
            "exception.",
            ["loop"], registry=reg)

        # Serving telemetry plane (docs/observability.md).
        self.grpc_duration_hist = Histogram(
            "gubernator_tpu_grpc_duration_seconds",
            "Per-method gRPC request latency histogram (log-spaced "
            "buckets; OpenMetrics exemplars carry the request span's "
            "trace id).",
            ["method"], registry=reg)
        self.stage_duration = Histogram(
            "gubernator_tpu_stage_duration_seconds",
            "Per-stage serving-window latency histogram (stages: decode, "
            "lease, pack, h2d, tick, resolve, encode), fed by the flight "
            "recorder when one is installed.",
            ["stage"], registry=reg)
        self.slow_windows = Counter(
            "gubernator_tpu_slow_windows",
            "Serving windows whose summed stage time exceeded "
            "GUBER_SLOW_WINDOW_MS; each one's flight record is dumped to "
            "the log by the watchdog.",
            registry=reg)

        # Overload control plane (docs/overload.md).
        self.arena_fallbacks = Counter(
            "gubernator_tpu_arena_fallbacks",
            "Wire-decode batches served from plain numpy allocations "
            "because every arena slab was busy; capped per window by "
            "GUBER_INGEST_FALLBACK_LIMIT, shed beyond the cap.",
            registry=reg)
        self.admission_shed = Counter(
            "gubernator_tpu_admission_shed",
            "Requests shed by the admission plane, by reason: expired "
            "(deadline passed before packing), overflow (bounded queue "
            "full), shutdown (drained at close), backpressure (ingest "
            "arena exhausted past the fallback cap).",
            ["reason"], registry=reg)
        self.admission_queue_depth = Gauge(
            "gubernator_tpu_admission_queue_depth",
            "Requests waiting in the bounded two-class admission queue "
            "(peer reconcile traffic + client traffic).",
            registry=reg)
        self.admission_window_limit = Gauge(
            "gubernator_tpu_admission_window_limit",
            "Current AIMD-admitted window width in requests (static "
            "batch_limit when GUBER_TARGET_P99_MS is 0).",
            registry=reg)
        self.admission_expired_served = Counter(
            "gubernator_tpu_admission_expired_served",
            "Invariant violations: requests whose deadline had already "
            "expired at pack time but that reached the engine anyway. "
            "Must stay 0; gated by the overload_shed bench rung.",
            registry=reg)

        # Cooperative quota-lease families (docs/leases.md).
        self.lease_grants = Counter(
            "gubernator_tpu_lease_grants",
            "Quota leases minted: budget delegated to a client for "
            "TTL-bounded local self-enforcement.",
            registry=reg)
        self.lease_renewals = Counter(
            "gubernator_tpu_lease_renewals",
            "Cheap lease extensions: held budget re-signed with a "
            "pushed-out TTL instead of a fresh decision (the overload "
            "degrade path).",
            registry=reg)
        self.lease_revocations = Counter(
            "gubernator_tpu_lease_revocations",
            "Lease generations bumped (limit config changed or explicit "
            "revoke); outstanding tokens die at their next sync.",
            registry=reg)
        self.lease_sync_loss = Counter(
            "gubernator_tpu_lease_sync_loss",
            "Admissions reported by lease syncs beyond the granted "
            "budget (stale-generation or misbehaving clients); "
            "force-charged to the bucket on reconcile.",
            registry=reg)
        self.lease_sync_dropped = Counter(
            "gubernator_tpu_lease_sync_dropped",
            "Lease reconcile accounting that never reached the bucket: "
            "credit/charge decisions shed under overload, force-charges "
            "bounced off the bucket floor, or excess synced against a "
            "key with no known config.",
            registry=reg)

    def sample(self, name: str, labels: Optional[dict] = None) -> float:
        """One sample's value (0.0 when unobserved); summaries expose
        ``<name>_count`` / ``<name>_sum``, counters ``<name>_total``."""
        v = self.registry.get_sample_value(name, labels or {})
        return 0.0 if v is None else v

    def expose(self) -> bytes:
        """The registry in Prometheus text exposition format."""
        return self.registry.expose()
