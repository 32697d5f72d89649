"""Configuration of a node and its cluster: library Config + daemon config.

The port's copy of the JAX package's ``config`` module (reference
``config.go:49-252``): ``BehaviorConfig`` inside ``Config`` inside
``DaemonConfig``, the same defaults and the same env-first setup
(``setup_daemon_config``): every knob is a ``GUBER_*`` environment
variable, and an optional ``key=value`` file is loaded into the
environment first.

Only the knobs of ported modules are read.  A knob of a module that is
not ported yet (edge workers, the metric-flag collectors) or of the JAX
package's TPU/XLA path raises a ``ValueError`` that names it, so no
setting is silently ignored.
"""

from __future__ import annotations

import logging
import os
import random
import socket
import string
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from gubernator_tpu_torch.resilience import ResilienceConfig
from gubernator_tpu_torch.types import MAX_BATCH_SIZE

log = logging.getLogger("gubernator.config")

# The ported ``GUBER_*`` surface: name -> what it sets.
ENV_REGISTRY: Dict[str, str] = {
    "GUBER_ADVERTISE_ADDRESS": "address peers use to reach this node",
    "GUBER_AUTOSCALE_COOLDOWN_DOWN": "autoscaler: quiet period before a scale-down",
    "GUBER_AUTOSCALE_COOLDOWN_UP": "autoscaler: quiet period before a scale-up",
    "GUBER_AUTOSCALE_DRY_RUN": "autoscaler: record decisions without acting",
    "GUBER_AUTOSCALE_ENABLED": "telemetry-driven shard autoscaler on/off",
    "GUBER_AUTOSCALE_HYSTERESIS": "autoscaler: scale-down band = target p99 × this",
    "GUBER_AUTOSCALE_INTERVAL": "autoscaler: signal sampling cadence",
    "GUBER_AUTOSCALE_MAX_PER_HOUR": "autoscaler: rolling-hour transition cap",
    "GUBER_AUTOSCALE_MAX_SHARDS": "autoscaler: shard-count ceiling",
    "GUBER_AUTOSCALE_MIN_SHARDS": "autoscaler: shard-count floor",
    "GUBER_AUTOSCALE_OCCUPANCY_LOW": "autoscaler: scale-down occupancy threshold",
    "GUBER_AUTOSCALE_QUEUE_HIGH": "autoscaler: scale-up queue-depth high-water",
    "GUBER_AUTOSCALE_TARGET_P99_MS": "autoscaler: scale-up window p99 threshold",
    "GUBER_AUTOSCALE_WINDOWS": "autoscaler: consecutive windows before acting",
    "GUBER_BATCH_LIMIT": "cap on requests a tick window coalesces",
    "GUBER_BATCH_TIMEOUT": "deadline for a forwarded peer batch",
    "GUBER_BATCH_WAIT": "batch accumulation window (the tick wait)",
    "GUBER_BREAKER_ENABLED": "per-peer circuit breakers on/off",
    "GUBER_BREAKER_FAILURE_THRESHOLD": "failure fraction that opens a breaker",
    "GUBER_BREAKER_HALF_OPEN_PROBES": "probe RPCs allowed half-open",
    "GUBER_BREAKER_MIN_REQUESTS": "min window samples before tripping",
    "GUBER_BREAKER_OPEN_CAP": "max open duration (backoff cap)",
    "GUBER_BREAKER_OPEN_FOR": "initial open duration",
    "GUBER_BREAKER_WINDOW": "sliding failure window length",
    "GUBER_CACHE_SIZE": "device bucket-table capacity (slots)",
    "GUBER_COLD_CACHE_SIZE": "host-side cold-tier entry budget (0 = off)",
    "GUBER_DATA_CENTER": "datacenter name for region-aware picking",
    "GUBER_DEBUG_ENDPOINTS": "serve /debug/pipeline, /debug/traces, /debug/state (0/1)",
    "GUBER_DISABLE_BATCHING": "disable peer-forwarding batches",
    "GUBER_DNS_FQDN": "dns discovery: name to resolve for peers",
    "GUBER_DRAIN_TIMEOUT": "graceful-shutdown GLOBAL flush budget",
    "GUBER_ETCD_DIAL_TIMEOUT": "etcd discovery: dial timeout",
    "GUBER_ETCD_ENDPOINTS": "etcd discovery: endpoints (comma list)",
    "GUBER_ETCD_KEY_PREFIX": "etcd discovery: peer key prefix",
    "GUBER_ETCD_PASSWORD": "etcd discovery: password",
    "GUBER_ETCD_USER": "etcd discovery: username",
    "GUBER_FAULT_DELAY": "fault injection: added per-RPC latency",
    "GUBER_FAULT_DROP_RATE": "fault injection: DEADLINE_EXCEEDED rate",
    "GUBER_FAULT_ERROR_RATE": "fault injection: UNAVAILABLE rate",
    "GUBER_FAULT_PARTITION": "fault injection: 100% UNAVAILABLE",
    "GUBER_FAULT_PEERS": "fault injection: target peers or '*'",
    "GUBER_FAULT_SEED": "fault injection: RNG seed",
    "GUBER_FEDERATION_BATCH_LIMIT": "max envelope records per federation flush",
    "GUBER_FEDERATION_ENABLED": "multi-region federation exchange on/off",
    "GUBER_FEDERATION_INTERVAL": "inter-region envelope exchange cadence",
    "GUBER_FEDERATION_TIMEOUT": "deadline for federation envelope RPCs",
    "GUBER_FLIGHT_RECORDER_WINDOWS": "flight-recorder ring size (window records)",
    "GUBER_FORCE_GLOBAL": "force GLOBAL behavior on every request",
    "GUBER_FORWARD_BACKOFF_BASE": "forward-retry backoff base",
    "GUBER_FORWARD_BACKOFF_CAP": "forward-retry backoff cap",
    "GUBER_FORWARD_MAX_ATTEMPTS": "forward-retry attempt budget",
    "GUBER_GLOBAL_BATCH_LIMIT": "max records per GLOBAL flush batch",
    "GUBER_GLOBAL_SYNC_WAIT": "GLOBAL reconcile cadence",
    "GUBER_GLOBAL_TIMEOUT": "deadline for GLOBAL RPCs",
    "GUBER_GRPC_ADDRESS": "gRPC listen address",
    "GUBER_GRPC_MAX_CONN_AGE_SEC": "max gRPC client connection age (0 = inf)",
    "GUBER_HTTP_ADDRESS": "HTTP/JSON gateway listen address",
    "GUBER_INGEST_ARENA_SLABS": "preallocated wire-decode column slabs (0 = off)",
    "GUBER_INGEST_FALLBACK_LIMIT": "arena-miss plain allocations per window before shed",
    "GUBER_INSTANCE_ID": "unique instance id for logs",
    "GUBER_K8S_ENDPOINTS_SELECTOR": "k8s discovery: endpoints selector",
    "GUBER_K8S_NAMESPACE": "k8s discovery: namespace",
    "GUBER_K8S_POD_IP": "k8s discovery: this pod's IP",
    "GUBER_K8S_POD_PORT": "k8s discovery: this pod's port",
    "GUBER_K8S_WATCH_MECHANISM": "k8s discovery: 'endpoints' or 'pods'",
    "GUBER_LEASE_BUDGET_FRACTION": "limit fraction delegated per lease grant",
    "GUBER_LEASE_CREDIT_BACK": "credit unused lease budget back on release (0/1)",
    "GUBER_LEASE_ENABLED": "cooperative quota-lease tier on/off",
    "GUBER_LEASE_MAX_BUDGET": "hard cap on admissions per lease grant",
    "GUBER_LEASE_OFFLINE_GRACE": "client lease extension window when owner unreachable",
    "GUBER_LEASE_SECRET": "shared HMAC lease-signing secret ('' = per-process)",
    "GUBER_LEASE_TTL": "lease validity window (duration)",
    "GUBER_LOG_FORMAT": "log format: text or json",
    "GUBER_LOG_LEVEL": "log level: debug/info/warning/error",
    "GUBER_MEMBERLIST_ADDRESS": "member-list discovery: bind address",
    "GUBER_MEMBERLIST_ADVERTISE_ADDRESS": "member-list: advertise address",
    "GUBER_MEMBERLIST_KNOWN_NODES": "member-list: seed nodes (comma list)",
    "GUBER_PEER_DISCOVERY_TYPE": "discovery pool: member-list/etcd/dns/k8s/none",
    "GUBER_PEER_PICKER": "peer picker implementation",
    "GUBER_PEER_PICKER_HASH": "picker hash: fnv1 or fnv1a",
    "GUBER_PEER_TIMEOUT_FLOOR": "min peer RPC timeout under deadline propagation",
    "GUBER_PENDING_LIMIT": "bounded admission queue cap in requests (0 = auto)",
    "GUBER_REDELIVERY_LIMIT": "GLOBAL redelivery buffer cap",
    "GUBER_REPLICATED_HASH_REPLICAS": "consistent-hash virtual replicas",
    "GUBER_REQUEST_TIMEOUT": "default per-request deadline budget",
    "GUBER_RESHARD_FREEZE_TIMEOUT": "reshard drain budget before abort",
    "GUBER_RESHARD_VERIFY": "audit the table after each reshard cutover",
    "GUBER_RESOLV_CONF": "dns discovery: resolv.conf path",
    "GUBER_SHED_POLICY": "overload shed answers: fail-open/fail-closed",
    "GUBER_SLOW_WINDOW_MS": "slow-window watchdog threshold in ms (0 = off)",
    "GUBER_SNAPSHOT_DELTAS_PER_BASE": "delta records per base compaction",
    "GUBER_SNAPSHOT_DIR": "crash-safe snapshot directory ('' = off)",
    "GUBER_SNAPSHOT_INTERVAL": "delta snapshot cadence (seconds)",
    "GUBER_SSD_CAPACITY_BYTES": "SSD-tier slab byte budget",
    "GUBER_SSD_COMPACT_RATIO": "slab garbage fraction that triggers compaction",
    "GUBER_SSD_DIR": "SSD-tier slab directory ('' = off)",
    "GUBER_SSD_QUEUE_DEPTH": "SSD writer queue depth (demote batches)",
    "GUBER_STATUS_HTTP_ADDRESS": "no-mTLS health/metrics listener",
    "GUBER_TARGET_P99_MS": "AIMD limiter window-p99 target in ms (0 = off)",
    "GUBER_TICK_PIPELINE_DEPTH": "dispatched-unresolved tick windows in flight",
    "GUBER_TLS_AUTO": "self-signed server TLS",
    "GUBER_TLS_CA": "TLS CA cert file",
    "GUBER_TLS_CA_KEY": "TLS CA key file (auto-signs server certs)",
    "GUBER_TLS_CERT": "TLS server cert file",
    "GUBER_TLS_CLIENT_AUTH": "client-cert policy for mTLS",
    "GUBER_TLS_CLIENT_AUTH_CA_CERT": "CA bundle validating client certs",
    "GUBER_TLS_CLIENT_AUTH_CERT": "client cert for peer dials",
    "GUBER_TLS_CLIENT_AUTH_KEY": "client key for peer dials",
    "GUBER_TLS_CLIENT_AUTH_SERVER_NAME": "expected server name on dials",
    "GUBER_TLS_INSECURE_SKIP_VERIFY": "skip peer cert verification (dev only)",
    "GUBER_TLS_KEY": "TLS server key file",
    "GUBER_TLS_MIN_VERSION": "minimum TLS version",
    "GUBER_TPU_BG_RECLAIM": "background reclaim: auto/on/off",
    "GUBER_TPU_GLOBAL_MESH_CAPACITY": "GLOBAL mesh slot capacity",
    "GUBER_TPU_GLOBAL_MESH_NODE": "this node's mesh index (-1 = auto: 0, one process drives the card)",
    "GUBER_TPU_GLOBAL_MESH_NODES": "GLOBAL mesh size (0 = gRPC loops only; the mesh lives in this process, which holds all its nodes)",
    "GUBER_TPU_MAX_BATCH": "request columns per device tick",
    "GUBER_TPU_MESH_SHARDS": "table shards (row ranges of one table on the card)",
    "GUBER_TPU_PLATFORM": "device: '' or 'cuda' (the card), 'cpu' (plain versions)",
}

_TPU = "a knob of the JAX package's TPU/XLA path with no counterpart here"

# Knobs of modules that are not ported yet -> where they belong.
UNPORTED: Dict[str, str] = {
    **{k: "the edge ingest plane" for k in (
        "GUBER_EDGE_RING_DEPTH", "GUBER_EDGE_SHM_SLABS",
        "GUBER_EDGE_WORKERS")},
    "GUBER_METRIC_FLAGS": "the process and runtime metric collectors",
    **{k: _TPU for k in (
        "GUBER_COMPILE_CACHE_DIR", "GUBER_SANITIZERS",
        "GUBER_TPU_DMA_RING", "GUBER_TPU_DMA_UNROLL",
        "GUBER_TPU_FUSED_TICK", "GUBER_TPU_SORTED32",
        "GUBER_TPU_TABLE_LAYOUT", "GUBER_MESH_ROUTING",
        "GUBER_MESH_LOCAL_WIDTH")},
}

PLATFORMS = ("", "cuda", "cpu")
DISCOVERY_TYPES = ("member-list", "etcd", "dns", "k8s", "none")


def env_knob(name: str, default=None, parse: Optional[Callable] = None,
             environ: Optional[Dict[str, str]] = None):
    """Read one registered ``GUBER_*`` knob; unset or empty returns
    ``default`` unparsed, and a parse failure names the knob."""
    if name not in ENV_REGISTRY:
        raise KeyError(f"{name} is not a ported knob (config.ENV_REGISTRY)")
    env = os.environ if environ is None else environ
    v = env.get(name, "")
    if v == "":
        return default
    if parse is None:
        return v
    try:
        return parse(v)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def reject_unported(environ: Dict[str, str]) -> None:
    """Raise for the first set knob of a module that is not ported."""
    for name, what in UNPORTED.items():
        if environ.get(name, "") != "":
            raise ValueError(f"{name} is not ported yet: {what}")


# Reference BatchLimit default (config.go:126-128).
DEFAULT_BATCH_LIMIT = 1000


@dataclass
class BehaviorConfig:
    """Batching and GLOBAL cadence knobs (reference config.go:49-70).
    Durations are seconds host-side: ``batch_*`` the forwarding batches
    (and ``batch_wait`` / ``batch_limit`` the tick window), ``global_*``
    the GLOBAL reconcile loops."""

    batch_timeout: float = 0.5
    batch_wait: float = 500e-6
    batch_limit: int = DEFAULT_BATCH_LIMIT
    # True when the operator set GUBER_BATCH_LIMIT (or a caller assigned
    # batch_limit): the tick window honors an explicit cap, else widens
    # to tpu_max_batch.
    batch_limit_set: bool = False
    disable_batching: bool = False
    global_timeout: float = 0.5
    global_sync_wait: float = 0.1
    global_batch_limit: int = 1000
    global_peer_requests_concurrency: int = 100
    force_global: bool = False

    def __post_init__(self) -> None:
        if self.batch_limit != DEFAULT_BATCH_LIMIT:
            self.batch_limit_set = True


@dataclass
class Config:
    """Library-level instance config (reference config.go:73-123)."""

    behaviors: BehaviorConfig = field(default_factory=BehaviorConfig)
    cache_size: int = 50_000
    data_center: str = ""
    local_picker_hash: str = "fnv1"  # GUBER_PEER_PICKER_HASH
    replicas: int = 512              # GUBER_REPLICATED_HASH_REPLICAS
    instance_id: str = ""
    tpu_max_batch: int = 4096        # request columns per device tick
    tpu_mesh_shards: int = 0         # 0 = TickEngine; N > 1 = MeshTickEngine
    tpu_platform: str = ""           # "" / "cuda": the card; "cpu": plain
    tpu_bg_reclaim: str = "auto"     # auto / on / off
    cold_cache_size: int = 0         # cold-tier entries (0 = no tiers)
    ssd_dir: str = ""                # SSD tier slab directory ("" = off)
    ssd_capacity_bytes: int = 1 << 30
    ssd_compact_ratio: float = 0.5
    ssd_queue_depth: int = 8
    snapshot_dir: str = ""           # persistence directory ("" = off)
    snapshot_interval: float = 5.0
    snapshot_deltas_per_base: int = 64
    drain_timeout: float = 2.0       # graceful-shutdown GLOBAL flush budget
    # Live resharding (parallel/reshard.py): the bounded quiesce before a
    # cutover aborts, and the post-cutover audit.
    reshard_freeze_timeout: float = 5.0
    reshard_verify: bool = True
    # Multi-region GLOBAL federation (federation/): owner-side GLOBAL
    # state changes also fan out as bounded-staleness envelopes to the
    # owning peer in every other datacenter, batched per
    # federation_interval over the breaker / backoff / redelivery path.
    # Requires data_center.  GUBER_FEDERATION_*.
    federation_enabled: bool = False
    federation_interval: float = 1.0
    federation_batch_limit: int = 1000
    federation_timeout: float = 1.0
    # The guardrailed shard autoscaler (autoscale/): samples the
    # admission, latency and occupancy telemetry every autoscale_interval
    # and drives live reshard transitions through hysteresis bands,
    # per-direction cooldowns and a rolling-hour flap cap.  Off by
    # default; when on it records decisions without acting until
    # GUBER_AUTOSCALE_DRY_RUN is turned off.  GUBER_AUTOSCALE_*.
    autoscale_enabled: bool = False
    autoscale_interval: float = 10.0
    autoscale_windows: int = 3
    autoscale_target_p99_ms: float = 5.0
    autoscale_queue_high: int = 1000
    autoscale_hysteresis: float = 0.5
    autoscale_occupancy_low: float = 0.3
    autoscale_min_shards: int = 1
    autoscale_max_shards: int = 8
    autoscale_cooldown_up: float = 60.0
    autoscale_cooldown_down: float = 300.0
    autoscale_max_per_hour: int = 4
    autoscale_dry_run: bool = True
    # GLOBAL reconciliation over the mesh's collectives data plane
    # (parallel/global_mesh.py): N logical peer-nodes, replicas in one
    # table on the card; 0 = gRPC loops only.  Node index -1 = auto,
    # which is 0 here: one process drives the card (the JAX package takes
    # jax.process_index(), a multi-host identity).
    tpu_global_mesh_nodes: int = 0
    tpu_global_mesh_node: int = -1
    tpu_global_mesh_capacity: int = 1 << 16
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    # A FaultInjector the peer clients consult before every RPC
    # (GUBER_FAULT_* builds one; tests install theirs directly).
    fault_injector: Optional[object] = None
    loader: Optional[object] = None
    store: Optional[object] = None

    def set_defaults(self) -> None:
        if not self.instance_id:
            self.instance_id = "".join(
                random.choice(string.ascii_lowercase + string.digits)
                for _ in range(10))
        if self.cache_size <= 0:
            self.cache_size = 50_000


# GLOBAL-mesh capacity envelope (parallel/global_mesh.py): the dense
# reconcile rewrites every slot of every replica each sync interval,
# independent of traffic, so the config surface warns past the soft bound
# and refuses the hard one instead of letting a typo configure a mesh that
# cannot keep its cadence.  Above 2^16 slots the sparse reconcile takes
# over on its own.
GLOBAL_MESH_CAPACITY_SOFT = 1 << 20
GLOBAL_MESH_CAPACITY_HARD = 1 << 24


def validate_global_mesh_capacity(capacity: int) -> None:
    """Raise past GLOBAL_MESH_CAPACITY_HARD, warn past _SOFT."""
    if capacity > GLOBAL_MESH_CAPACITY_HARD:
        raise ValueError(
            f"GUBER_TPU_GLOBAL_MESH_CAPACITY={capacity} exceeds "
            f"{GLOBAL_MESH_CAPACITY_HARD} (2^24); the dense reconcile "
            "rewrites O(capacity * nodes) rows every sync interval and "
            "cannot serve tables this large; GLOBAL limits are a small "
            "hot subset, so shard the serving table instead "
            "(parallel/global_mesh.py)")
    if capacity > GLOBAL_MESH_CAPACITY_SOFT:
        log.warning(
            "GUBER_TPU_GLOBAL_MESH_CAPACITY=%d is past the documented "
            "envelope (2^14-2^20): a dense reconcile rewrites every slot "
            "on every node, so expect the sync cadence to stretch "
            "(parallel/global_mesh.py)", capacity)


def validate_federation(conf: Config) -> None:
    """The reference's checks of the four ``GUBER_FEDERATION_*`` knobs."""
    if conf.federation_interval <= 0:
        raise ValueError(
            f"GUBER_FEDERATION_INTERVAL must be > 0; "
            f"got {conf.federation_interval}")
    if not 1 <= conf.federation_batch_limit <= MAX_BATCH_SIZE:
        # The receiver applies an envelope through the peer batch
        # handler, which rejects batches over MAX_BATCH_SIZE: a larger
        # envelope would fail every apply and wedge its channel in
        # permanent redelivery.
        raise ValueError(
            f"GUBER_FEDERATION_BATCH_LIMIT must be in "
            f"[1, {MAX_BATCH_SIZE}]; got {conf.federation_batch_limit}")
    if conf.federation_timeout <= 0:
        raise ValueError(
            f"GUBER_FEDERATION_TIMEOUT must be > 0; "
            f"got {conf.federation_timeout}")
    if conf.federation_enabled and not conf.data_center:
        raise ValueError(
            "GUBER_FEDERATION_ENABLED requires GUBER_DATA_CENTER: regions "
            "are keyed by datacenter name and this node must know its own")


def validate_autoscale(conf: Config) -> None:
    """The reference's checks of the thirteen ``GUBER_AUTOSCALE_*`` knobs."""
    if conf.autoscale_interval <= 0:
        raise ValueError(
            f"GUBER_AUTOSCALE_INTERVAL must be > 0; "
            f"got {conf.autoscale_interval}")
    if conf.autoscale_windows < 1:
        raise ValueError(
            f"GUBER_AUTOSCALE_WINDOWS must be >= 1; "
            f"got {conf.autoscale_windows}")
    if conf.autoscale_target_p99_ms < 0:
        raise ValueError(
            f"GUBER_AUTOSCALE_TARGET_P99_MS must be >= 0 (0 disables the "
            f"latency signal); got {conf.autoscale_target_p99_ms}")
    if conf.autoscale_queue_high < 1:
        raise ValueError(
            f"GUBER_AUTOSCALE_QUEUE_HIGH must be >= 1; "
            f"got {conf.autoscale_queue_high}")
    if not 0.0 < conf.autoscale_hysteresis < 1.0:
        # Strict: 1 would make the scale-down latency band touch the
        # scale-up band, and a p99 sitting at the target could ping-pong.
        raise ValueError(
            f"GUBER_AUTOSCALE_HYSTERESIS must be in (0, 1) so the up and "
            f"down bands never overlap; got {conf.autoscale_hysteresis}")
    if not 0.0 <= conf.autoscale_occupancy_low <= 1.0:
        raise ValueError(
            f"GUBER_AUTOSCALE_OCCUPANCY_LOW must be in [0, 1]; "
            f"got {conf.autoscale_occupancy_low}")
    if conf.autoscale_min_shards < 1:
        raise ValueError(
            f"GUBER_AUTOSCALE_MIN_SHARDS must be >= 1; "
            f"got {conf.autoscale_min_shards}")
    if conf.autoscale_max_shards < conf.autoscale_min_shards:
        raise ValueError(
            f"GUBER_AUTOSCALE_MAX_SHARDS must be >= "
            f"GUBER_AUTOSCALE_MIN_SHARDS; got "
            f"{conf.autoscale_max_shards} < {conf.autoscale_min_shards}")
    if conf.autoscale_cooldown_up < 0 or conf.autoscale_cooldown_down < 0:
        raise ValueError(
            f"GUBER_AUTOSCALE_COOLDOWN_UP/_DOWN must be >= 0; got "
            f"{conf.autoscale_cooldown_up}/{conf.autoscale_cooldown_down}")
    if conf.autoscale_max_per_hour < 1:
        raise ValueError(
            f"GUBER_AUTOSCALE_MAX_PER_HOUR must be >= 1; "
            f"got {conf.autoscale_max_per_hour}")


@dataclass
class TLSSettings:
    """TLS file paths and modes (reference config.go:330-420)."""

    ca_file: str = ""
    ca_key_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    auto_tls: bool = False
    # "", "request", "verify-if-given", "require", "require-and-verify"
    client_auth: str = ""
    client_auth_ca_file: str = ""
    client_auth_cert_file: str = ""
    client_auth_key_file: str = ""
    client_auth_server_name: str = ""
    insecure_skip_verify: bool = False
    min_version: str = "1.3"

    @property
    def enabled(self) -> bool:
        return bool(self.auto_tls or self.cert_file or self.key_file
                    or self.ca_file)


@dataclass
class DaemonConfig:
    """Daemon-level config (reference config.go:181-252)."""

    grpc_listen_address: str = "localhost:81"
    http_listen_address: str = "localhost:80"
    http_status_listen_address: str = ""   # plaintext status listener
    advertise_address: str = ""
    config: Config = field(default_factory=Config)
    peer_discovery_type: str = "none"
    data_center: str = ""
    log_level: str = "info"
    log_format: str = "text"
    grpc_max_conn_age_sec: int = 0

    # member-list discovery
    memberlist_address: str = ""
    memberlist_advertise_address: str = ""
    memberlist_known_nodes: List[str] = field(default_factory=list)

    # etcd discovery
    etcd_endpoints: List[str] = field(default_factory=list)
    etcd_key_prefix: str = "/gubernator-tpu/peers/"
    etcd_user: str = ""
    etcd_password: str = ""
    etcd_dial_timeout: float = 5.0

    # k8s discovery
    k8s_namespace: str = ""
    k8s_pod_ip: str = ""
    k8s_pod_port: str = ""
    k8s_endpoints_selector: str = ""
    k8s_watch_mechanism: str = "endpoints"

    # dns discovery
    dns_fqdn: str = ""
    dns_resolv_conf: str = "/etc/resolv.conf"

    tls: TLSSettings = field(default_factory=TLSSettings)

    def client_tls(self) -> Optional[TLSSettings]:
        return self.tls if self.tls.enabled else None


def load_config_file(path: str,
                     environ: Optional[Dict[str, str]] = None) -> None:
    """Load a ``key=value`` file into the environment (reference
    config.go:635-658); variables already set win."""
    env = environ if environ is not None else os.environ
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                raise ValueError(
                    f"{path}:{lineno}: expected 'key=value', got {line!r}")
            k, _, v = line.partition("=")
            k, v = k.strip(), v.strip()
            if k and k not in env:
                env[k] = v


class EnvReader:
    """Typed ``GUBER_*`` reads with default fallbacks."""

    def __init__(self, environ: Optional[Dict[str, str]] = None):
        self.env = environ if environ is not None else os.environ

    def str_(self, name: str, default: str = "") -> str:
        v = self.env.get(name, "")
        return v if v != "" else default

    def has(self, name: str) -> bool:
        return self.env.get(name, "") != ""

    def int_(self, name: str, default: int = 0) -> int:
        v = self.env.get(name, "")
        if v == "":
            return default
        try:
            return int(v)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None

    def float_seconds(self, name: str, default: float) -> float:
        """A duration: Go-style suffixes (``500ms``, ``30s``, ``1m``) or
        a plain float of seconds."""
        v = self.env.get(name, "")
        if v == "":
            return default
        return parse_duration(v)

    def bool_(self, name: str, default: bool = False) -> bool:
        v = self.env.get(name, "").lower()
        if v == "":
            return default
        return v in ("1", "true", "yes", "on")

    def list_(self, name: str,
              default: Optional[List[str]] = None) -> List[str]:
        v = self.env.get(name, "")
        if v == "":
            return list(default or [])
        return [x.strip() for x in v.split(",") if x.strip()]


_DUR_UNITS = [  # longest suffix first so "ms" wins over "s"
    ("ms", 1e-3), ("us", 1e-6), ("µs", 1e-6), ("ns", 1e-9),
    ("s", 1.0), ("m", 60.0), ("h", 3600.0),
]


def parse_duration(v: str) -> float:
    """A Go-style duration string in seconds."""
    v = v.strip()
    for suffix, mult in _DUR_UNITS:
        if v.endswith(suffix):
            return float(v[: -len(suffix)]) * mult
    return float(v)


def setup_daemon_config(
    config_file: str = "",
    environ: Optional[Dict[str, str]] = None,
) -> DaemonConfig:
    """A DaemonConfig from the environment (+ an optional config file),
    as the reference's ``SetupDaemonConfig`` (config.go:270-479) for the
    ported knobs; a set knob of an unported module raises."""
    env = dict(os.environ) if environ is None else dict(environ)
    if config_file:
        load_config_file(config_file, env)
    reject_unported(env)
    r = EnvReader(env)

    behaviors = BehaviorConfig(
        batch_timeout=r.float_seconds("GUBER_BATCH_TIMEOUT", 0.5),
        batch_wait=r.float_seconds("GUBER_BATCH_WAIT", 500e-6),
        batch_limit=r.int_("GUBER_BATCH_LIMIT", DEFAULT_BATCH_LIMIT),
        batch_limit_set=r.has("GUBER_BATCH_LIMIT"),
        disable_batching=r.bool_("GUBER_DISABLE_BATCHING"),
        global_timeout=r.float_seconds("GUBER_GLOBAL_TIMEOUT", 0.5),
        global_sync_wait=r.float_seconds("GUBER_GLOBAL_SYNC_WAIT", 0.1),
        global_batch_limit=r.int_("GUBER_GLOBAL_BATCH_LIMIT", 1000),
        force_global=r.bool_("GUBER_FORCE_GLOBAL"),
    )
    resilience = ResilienceConfig(
        breaker_enabled=r.bool_("GUBER_BREAKER_ENABLED", True),
        breaker_failure_threshold=float(
            r.str_("GUBER_BREAKER_FAILURE_THRESHOLD", "0.5")),
        breaker_min_requests=r.int_("GUBER_BREAKER_MIN_REQUESTS", 5),
        breaker_window=r.float_seconds("GUBER_BREAKER_WINDOW", 10.0),
        breaker_open_for=r.float_seconds("GUBER_BREAKER_OPEN_FOR", 2.0),
        breaker_open_cap=r.float_seconds("GUBER_BREAKER_OPEN_CAP", 30.0),
        breaker_half_open_probes=r.int_("GUBER_BREAKER_HALF_OPEN_PROBES", 1),
        forward_max_attempts=r.int_("GUBER_FORWARD_MAX_ATTEMPTS", 5),
        forward_backoff_base=r.float_seconds(
            "GUBER_FORWARD_BACKOFF_BASE", 0.005),
        forward_backoff_cap=r.float_seconds("GUBER_FORWARD_BACKOFF_CAP", 0.1),
        redelivery_limit=r.int_("GUBER_REDELIVERY_LIMIT", 10_000),
    )
    from gubernator_tpu_torch.resilience import FaultInjector

    conf = Config(
        behaviors=behaviors,
        resilience=resilience,
        fault_injector=FaultInjector.from_env(r),
        data_center=r.str_("GUBER_DATA_CENTER"),
        local_picker_hash=r.str_("GUBER_PEER_PICKER_HASH", "fnv1"),
        replicas=r.int_("GUBER_REPLICATED_HASH_REPLICAS", 512),
        drain_timeout=r.float_seconds("GUBER_DRAIN_TIMEOUT", 2.0),
        reshard_freeze_timeout=r.float_seconds(
            "GUBER_RESHARD_FREEZE_TIMEOUT", 5.0),
        reshard_verify=r.bool_("GUBER_RESHARD_VERIFY", True),
        federation_enabled=r.bool_("GUBER_FEDERATION_ENABLED"),
        federation_interval=r.float_seconds("GUBER_FEDERATION_INTERVAL", 1.0),
        federation_batch_limit=r.int_("GUBER_FEDERATION_BATCH_LIMIT", 1000),
        federation_timeout=r.float_seconds("GUBER_FEDERATION_TIMEOUT", 1.0),
        autoscale_enabled=r.bool_("GUBER_AUTOSCALE_ENABLED"),
        autoscale_interval=r.float_seconds("GUBER_AUTOSCALE_INTERVAL", 10.0),
        autoscale_windows=r.int_("GUBER_AUTOSCALE_WINDOWS", 3),
        autoscale_target_p99_ms=float(
            r.str_("GUBER_AUTOSCALE_TARGET_P99_MS", "5.0")),
        autoscale_queue_high=r.int_("GUBER_AUTOSCALE_QUEUE_HIGH", 1000),
        autoscale_hysteresis=float(
            r.str_("GUBER_AUTOSCALE_HYSTERESIS", "0.5")),
        autoscale_occupancy_low=float(
            r.str_("GUBER_AUTOSCALE_OCCUPANCY_LOW", "0.3")),
        autoscale_min_shards=r.int_("GUBER_AUTOSCALE_MIN_SHARDS", 1),
        autoscale_max_shards=r.int_("GUBER_AUTOSCALE_MAX_SHARDS", 8),
        autoscale_cooldown_up=r.float_seconds(
            "GUBER_AUTOSCALE_COOLDOWN_UP", 60.0),
        autoscale_cooldown_down=r.float_seconds(
            "GUBER_AUTOSCALE_COOLDOWN_DOWN", 300.0),
        autoscale_max_per_hour=r.int_("GUBER_AUTOSCALE_MAX_PER_HOUR", 4),
        autoscale_dry_run=r.bool_("GUBER_AUTOSCALE_DRY_RUN", True),
        cache_size=r.int_("GUBER_CACHE_SIZE", 50_000),
        cold_cache_size=r.int_("GUBER_COLD_CACHE_SIZE", 0),
        ssd_dir=r.str_("GUBER_SSD_DIR"),
        ssd_capacity_bytes=r.int_("GUBER_SSD_CAPACITY_BYTES", 1 << 30),
        ssd_compact_ratio=float(r.str_("GUBER_SSD_COMPACT_RATIO", "0.5")),
        ssd_queue_depth=r.int_("GUBER_SSD_QUEUE_DEPTH", 8),
        snapshot_dir=r.str_("GUBER_SNAPSHOT_DIR"),
        snapshot_interval=r.float_seconds("GUBER_SNAPSHOT_INTERVAL", 5.0),
        snapshot_deltas_per_base=r.int_("GUBER_SNAPSHOT_DELTAS_PER_BASE", 64),
        instance_id=r.str_("GUBER_INSTANCE_ID"),
        tpu_max_batch=r.int_("GUBER_TPU_MAX_BATCH", 4096),
        tpu_bg_reclaim=r.str_("GUBER_TPU_BG_RECLAIM", "auto"),
        tpu_mesh_shards=r.int_("GUBER_TPU_MESH_SHARDS", 0),
        tpu_platform=r.str_("GUBER_TPU_PLATFORM"),
        tpu_global_mesh_nodes=r.int_("GUBER_TPU_GLOBAL_MESH_NODES", 0),
        tpu_global_mesh_node=r.int_("GUBER_TPU_GLOBAL_MESH_NODE", -1),
        tpu_global_mesh_capacity=r.int_(
            "GUBER_TPU_GLOBAL_MESH_CAPACITY", 1 << 16),
    )
    conf.set_defaults()

    if conf.tpu_platform not in PLATFORMS:
        raise ValueError(
            f"GUBER_TPU_PLATFORM must be '', 'cuda' or 'cpu'; "
            f"got {conf.tpu_platform!r}")
    if conf.tpu_bg_reclaim not in ("auto", "on", "off"):
        raise ValueError(
            f"GUBER_TPU_BG_RECLAIM must be auto, on, or off; "
            f"got {conf.tpu_bg_reclaim!r}")
    if conf.cold_cache_size < 0:
        raise ValueError(
            f"GUBER_COLD_CACHE_SIZE must be >= 0; got {conf.cold_cache_size}")
    if conf.ssd_dir and conf.cold_cache_size <= 0:
        raise ValueError(
            "GUBER_SSD_DIR requires GUBER_COLD_CACHE_SIZE > 0: the SSD "
            "tier only ever holds cold-tier overflow")
    if conf.ssd_dir and conf.tpu_mesh_shards > 1:
        raise ValueError(
            "GUBER_SSD_DIR is not supported by the sharded mesh engine "
            "(GUBER_TPU_MESH_SHARDS > 1): the SSD tier hangs off the "
            "single-card cold store; unset one of the two")
    if conf.ssd_capacity_bytes <= 0:
        raise ValueError(
            f"GUBER_SSD_CAPACITY_BYTES must be > 0; "
            f"got {conf.ssd_capacity_bytes}")
    if not 0.0 < conf.ssd_compact_ratio <= 1.0:
        raise ValueError(
            f"GUBER_SSD_COMPACT_RATIO must be in (0, 1]; "
            f"got {conf.ssd_compact_ratio}")
    if conf.ssd_queue_depth < 1:
        raise ValueError(
            f"GUBER_SSD_QUEUE_DEPTH must be >= 1; got {conf.ssd_queue_depth}")
    if conf.snapshot_interval <= 0:
        raise ValueError(
            f"GUBER_SNAPSHOT_INTERVAL must be > 0; "
            f"got {conf.snapshot_interval}")
    if conf.snapshot_deltas_per_base < 1:
        raise ValueError(
            f"GUBER_SNAPSHOT_DELTAS_PER_BASE must be >= 1; "
            f"got {conf.snapshot_deltas_per_base}")
    if conf.drain_timeout < 0:
        raise ValueError(
            f"GUBER_DRAIN_TIMEOUT must be >= 0; got {conf.drain_timeout}")
    if conf.reshard_freeze_timeout <= 0:
        raise ValueError(
            f"GUBER_RESHARD_FREEZE_TIMEOUT must be > 0; "
            f"got {conf.reshard_freeze_timeout}")
    validate_federation(conf)
    validate_autoscale(conf)
    if not 0.0 < resilience.breaker_failure_threshold <= 1.0:
        raise ValueError(
            f"GUBER_BREAKER_FAILURE_THRESHOLD must be in (0, 1]; "
            f"got {resilience.breaker_failure_threshold}")
    if resilience.forward_max_attempts < 0:
        raise ValueError(
            f"GUBER_FORWARD_MAX_ATTEMPTS must be >= 0; "
            f"got {resilience.forward_max_attempts}")
    if resilience.redelivery_limit < 0:
        raise ValueError(
            f"GUBER_REDELIVERY_LIMIT must be >= 0; "
            f"got {resilience.redelivery_limit}")
    validate_global_mesh_capacity(conf.tpu_global_mesh_capacity)
    if conf.local_picker_hash not in ("fnv1", "fnv1a"):
        raise ValueError(
            "GUBER_PEER_PICKER_HASH is invalid; choose one of 'fnv1', "
            "'fnv1a'")
    if r.str_("GUBER_PEER_PICKER", "replicated-hash") != "replicated-hash":
        raise ValueError(
            "GUBER_PEER_PICKER is invalid; 'replicated-hash' is the only "
            "picker")
    discovery = r.str_("GUBER_PEER_DISCOVERY_TYPE", "none")
    if discovery not in DISCOVERY_TYPES:
        raise ValueError(
            f"GUBER_PEER_DISCOVERY_TYPE is invalid; choose one of "
            f"{DISCOVERY_TYPES}")

    tls = TLSSettings(
        ca_file=r.str_("GUBER_TLS_CA"),
        ca_key_file=r.str_("GUBER_TLS_CA_KEY"),
        cert_file=r.str_("GUBER_TLS_CERT"),
        key_file=r.str_("GUBER_TLS_KEY"),
        auto_tls=r.bool_("GUBER_TLS_AUTO"),
        client_auth=r.str_("GUBER_TLS_CLIENT_AUTH"),
        client_auth_ca_file=r.str_("GUBER_TLS_CLIENT_AUTH_CA_CERT"),
        client_auth_cert_file=r.str_("GUBER_TLS_CLIENT_AUTH_CERT"),
        client_auth_key_file=r.str_("GUBER_TLS_CLIENT_AUTH_KEY"),
        client_auth_server_name=r.str_("GUBER_TLS_CLIENT_AUTH_SERVER_NAME"),
        insecure_skip_verify=r.bool_("GUBER_TLS_INSECURE_SKIP_VERIFY"),
        min_version=r.str_("GUBER_TLS_MIN_VERSION", "1.3"),
    )

    return DaemonConfig(
        grpc_listen_address=r.str_("GUBER_GRPC_ADDRESS", f"{local_host()}:81"),
        http_listen_address=r.str_("GUBER_HTTP_ADDRESS", f"{local_host()}:80"),
        http_status_listen_address=r.str_("GUBER_STATUS_HTTP_ADDRESS"),
        advertise_address=r.str_("GUBER_ADVERTISE_ADDRESS"),
        config=conf,
        peer_discovery_type=discovery,
        data_center=r.str_("GUBER_DATA_CENTER"),
        log_level=r.str_("GUBER_LOG_LEVEL", "info"),
        log_format=r.str_("GUBER_LOG_FORMAT", "text"),
        grpc_max_conn_age_sec=r.int_("GUBER_GRPC_MAX_CONN_AGE_SEC", 0),
        memberlist_address=r.str_("GUBER_MEMBERLIST_ADDRESS"),
        memberlist_advertise_address=r.str_(
            "GUBER_MEMBERLIST_ADVERTISE_ADDRESS"),
        memberlist_known_nodes=r.list_("GUBER_MEMBERLIST_KNOWN_NODES"),
        etcd_endpoints=r.list_("GUBER_ETCD_ENDPOINTS", ["localhost:2379"]),
        etcd_key_prefix=r.str_("GUBER_ETCD_KEY_PREFIX",
                               "/gubernator-tpu/peers/"),
        etcd_user=r.str_("GUBER_ETCD_USER"),
        etcd_password=r.str_("GUBER_ETCD_PASSWORD"),
        etcd_dial_timeout=r.float_seconds("GUBER_ETCD_DIAL_TIMEOUT", 5.0),
        k8s_namespace=r.str_("GUBER_K8S_NAMESPACE", "default"),
        k8s_pod_ip=r.str_("GUBER_K8S_POD_IP"),
        k8s_pod_port=r.str_("GUBER_K8S_POD_PORT"),
        k8s_endpoints_selector=r.str_("GUBER_K8S_ENDPOINTS_SELECTOR"),
        k8s_watch_mechanism=r.str_("GUBER_K8S_WATCH_MECHANISM", "endpoints"),
        dns_fqdn=r.str_("GUBER_DNS_FQDN"),
        dns_resolv_conf=r.str_("GUBER_RESOLV_CONF", "/etc/resolv.conf"),
        tls=tls,
    )


def local_host() -> str:
    """Bind-address default: 'localhost' unless it does not resolve
    (reference config.go:498-511)."""
    try:
        socket.getaddrinfo("localhost", None)
        return "localhost"
    except OSError:
        return "127.0.0.1"
