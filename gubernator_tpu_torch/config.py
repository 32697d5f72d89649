"""Configuration of a standalone node: library Config + daemon config.

The port's copy of the JAX package's ``config`` module (reference
``config.go:49-252``): ``BehaviorConfig`` inside ``Config`` inside
``DaemonConfig``, the same defaults and the same env-first setup
(``setup_daemon_config``): every knob is a ``GUBER_*`` environment
variable, and an optional ``key=value`` file is loaded into the
environment first.

Only the knobs of ported modules are read.  A knob of a module that is
not ported yet (the cluster, discovery other than ``none``, TLS, leases,
federation, resharding, the autoscaler, edge workers, the GLOBAL mesh) or
of the JAX package's TPU/XLA path raises a ``ValueError`` that names it,
so no setting is silently ignored.
"""

from __future__ import annotations

import os
import random
import socket
import string
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from gubernator_tpu_torch.resilience import ResilienceConfig

# The ported ``GUBER_*`` surface: name -> what it sets.
ENV_REGISTRY: Dict[str, str] = {
    "GUBER_ADVERTISE_ADDRESS": "address peers use to reach this node",
    "GUBER_BATCH_LIMIT": "cap on requests a tick window coalesces",
    "GUBER_BATCH_WAIT": "batch accumulation window (the tick wait)",
    "GUBER_CACHE_SIZE": "device bucket-table capacity (slots)",
    "GUBER_COLD_CACHE_SIZE": "host-side cold-tier entry budget (0 = off)",
    "GUBER_DEBUG_ENDPOINTS": "serve /debug/pipeline, /debug/traces, /debug/state (0/1)",
    "GUBER_FLIGHT_RECORDER_WINDOWS": "flight-recorder ring size (window records)",
    "GUBER_FORCE_GLOBAL": "force GLOBAL behavior on every request",
    "GUBER_GRPC_ADDRESS": "gRPC listen address",
    "GUBER_GRPC_MAX_CONN_AGE_SEC": "max gRPC client connection age (0 = inf)",
    "GUBER_HTTP_ADDRESS": "HTTP/JSON gateway listen address",
    "GUBER_INGEST_ARENA_SLABS": "preallocated wire-decode column slabs (0 = off)",
    "GUBER_INGEST_FALLBACK_LIMIT": "arena-miss plain allocations per window before shed",
    "GUBER_INSTANCE_ID": "unique instance id for logs",
    "GUBER_LOG_FORMAT": "log format: text or json",
    "GUBER_LOG_LEVEL": "log level: debug/info/warning/error",
    "GUBER_PEER_DISCOVERY_TYPE": "discovery pool: only 'none' is ported",
    "GUBER_PENDING_LIMIT": "bounded admission queue cap in requests (0 = auto)",
    "GUBER_REQUEST_TIMEOUT": "default per-request deadline budget",
    "GUBER_SHED_POLICY": "overload shed answers: fail-open/fail-closed",
    "GUBER_SLOW_WINDOW_MS": "slow-window watchdog threshold in ms (0 = off)",
    "GUBER_SNAPSHOT_DELTAS_PER_BASE": "delta records per base compaction",
    "GUBER_SNAPSHOT_DIR": "crash-safe snapshot directory ('' = off)",
    "GUBER_SNAPSHOT_INTERVAL": "delta snapshot cadence (seconds)",
    "GUBER_SSD_CAPACITY_BYTES": "SSD-tier slab byte budget",
    "GUBER_SSD_COMPACT_RATIO": "slab garbage fraction that triggers compaction",
    "GUBER_SSD_DIR": "SSD-tier slab directory ('' = off)",
    "GUBER_SSD_QUEUE_DEPTH": "SSD writer queue depth (demote batches)",
    "GUBER_TARGET_P99_MS": "AIMD limiter window-p99 target in ms (0 = off)",
    "GUBER_TICK_PIPELINE_DEPTH": "dispatched-unresolved tick windows in flight",
    "GUBER_TPU_BG_RECLAIM": "background reclaim: auto/on/off",
    "GUBER_TPU_MAX_BATCH": "request columns per device tick",
    "GUBER_TPU_MESH_SHARDS": "table shards (row ranges of one table on the card)",
    "GUBER_TPU_PLATFORM": "device: '' or 'cuda' (the card), 'cpu' (plain versions)",
}

_CLUSTER = "the cluster (peers, forwarding, GLOBAL reconcile; ROADMAP A.3b)"
_DISCOVERY = "peer discovery (ROADMAP A.3b)"
_TPU = "a knob of the JAX package's TPU/XLA path with no counterpart here"

# Knobs of modules that are not ported yet -> where they belong.
UNPORTED: Dict[str, str] = {
    **{k: _CLUSTER for k in (
        "GUBER_BATCH_TIMEOUT", "GUBER_DISABLE_BATCHING",
        "GUBER_GLOBAL_TIMEOUT", "GUBER_GLOBAL_SYNC_WAIT",
        "GUBER_GLOBAL_BATCH_LIMIT", "GUBER_DATA_CENTER",
        "GUBER_DRAIN_TIMEOUT", "GUBER_PEER_PICKER",
        "GUBER_PEER_PICKER_HASH", "GUBER_REPLICATED_HASH_REPLICAS",
        "GUBER_PEER_TIMEOUT_FLOOR", "GUBER_REDELIVERY_LIMIT",
        "GUBER_BREAKER_ENABLED", "GUBER_BREAKER_FAILURE_THRESHOLD",
        "GUBER_BREAKER_HALF_OPEN_PROBES", "GUBER_BREAKER_MIN_REQUESTS",
        "GUBER_BREAKER_OPEN_CAP", "GUBER_BREAKER_OPEN_FOR",
        "GUBER_BREAKER_WINDOW", "GUBER_FORWARD_BACKOFF_BASE",
        "GUBER_FORWARD_BACKOFF_CAP", "GUBER_FORWARD_MAX_ATTEMPTS",
        "GUBER_FAULT_DELAY", "GUBER_FAULT_DROP_RATE",
        "GUBER_FAULT_ERROR_RATE", "GUBER_FAULT_PARTITION",
        "GUBER_FAULT_PEERS", "GUBER_FAULT_SEED")},
    **{k: _DISCOVERY for k in (
        "GUBER_DNS_FQDN", "GUBER_RESOLV_CONF", "GUBER_ETCD_DIAL_TIMEOUT",
        "GUBER_ETCD_ENDPOINTS", "GUBER_ETCD_KEY_PREFIX",
        "GUBER_ETCD_PASSWORD", "GUBER_ETCD_USER",
        "GUBER_K8S_ENDPOINTS_SELECTOR", "GUBER_K8S_NAMESPACE",
        "GUBER_K8S_POD_IP", "GUBER_K8S_POD_PORT",
        "GUBER_K8S_WATCH_MECHANISM", "GUBER_MEMBERLIST_ADDRESS",
        "GUBER_MEMBERLIST_ADVERTISE_ADDRESS",
        "GUBER_MEMBERLIST_KNOWN_NODES")},
    **{k: "TLS (ROADMAP A.3b)" for k in (
        "GUBER_TLS_AUTO", "GUBER_TLS_CA", "GUBER_TLS_CA_KEY",
        "GUBER_TLS_CERT", "GUBER_TLS_CLIENT_AUTH",
        "GUBER_TLS_CLIENT_AUTH_CA_CERT", "GUBER_TLS_CLIENT_AUTH_CERT",
        "GUBER_TLS_CLIENT_AUTH_KEY", "GUBER_TLS_CLIENT_AUTH_SERVER_NAME",
        "GUBER_TLS_INSECURE_SKIP_VERIFY", "GUBER_TLS_KEY",
        "GUBER_TLS_MIN_VERSION", "GUBER_STATUS_HTTP_ADDRESS")},
    **{k: "quota leases" for k in (
        "GUBER_LEASE_BUDGET_FRACTION", "GUBER_LEASE_CREDIT_BACK",
        "GUBER_LEASE_ENABLED", "GUBER_LEASE_MAX_BUDGET",
        "GUBER_LEASE_OFFLINE_GRACE", "GUBER_LEASE_SECRET",
        "GUBER_LEASE_TTL")},
    **{k: "multi-region federation" for k in (
        "GUBER_FEDERATION_BATCH_LIMIT", "GUBER_FEDERATION_ENABLED",
        "GUBER_FEDERATION_INTERVAL", "GUBER_FEDERATION_TIMEOUT")},
    **{k: "live resharding" for k in (
        "GUBER_RESHARD_FREEZE_TIMEOUT", "GUBER_RESHARD_VERIFY")},
    **{k: "the shard autoscaler" for k in (
        "GUBER_AUTOSCALE_COOLDOWN_DOWN", "GUBER_AUTOSCALE_COOLDOWN_UP",
        "GUBER_AUTOSCALE_DRY_RUN", "GUBER_AUTOSCALE_ENABLED",
        "GUBER_AUTOSCALE_HYSTERESIS", "GUBER_AUTOSCALE_INTERVAL",
        "GUBER_AUTOSCALE_MAX_PER_HOUR", "GUBER_AUTOSCALE_MAX_SHARDS",
        "GUBER_AUTOSCALE_MIN_SHARDS", "GUBER_AUTOSCALE_OCCUPANCY_LOW",
        "GUBER_AUTOSCALE_QUEUE_HIGH", "GUBER_AUTOSCALE_TARGET_P99_MS",
        "GUBER_AUTOSCALE_WINDOWS")},
    **{k: "the edge ingest plane" for k in (
        "GUBER_EDGE_RING_DEPTH", "GUBER_EDGE_SHM_SLABS",
        "GUBER_EDGE_WORKERS")},
    **{k: "the GLOBAL mesh (ROADMAP A.4)" for k in (
        "GUBER_TPU_GLOBAL_MESH_CAPACITY", "GUBER_TPU_GLOBAL_MESH_NODE",
        "GUBER_TPU_GLOBAL_MESH_NODES")},
    "GUBER_METRIC_FLAGS": "the process and runtime metric collectors",
    **{k: _TPU for k in (
        "GUBER_COMPILE_CACHE_DIR", "GUBER_SANITIZERS",
        "GUBER_TPU_DMA_RING", "GUBER_TPU_DMA_UNROLL",
        "GUBER_TPU_FUSED_TICK", "GUBER_TPU_SORTED32",
        "GUBER_TPU_TABLE_LAYOUT", "GUBER_MESH_ROUTING",
        "GUBER_MESH_LOCAL_WIDTH")},
}

PLATFORMS = ("", "cuda", "cpu")


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
    Durations are seconds host-side.  A standalone node reads
    ``batch_wait``, ``batch_limit`` and ``force_global``; the rest
    configure the cluster."""

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
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    loader: Optional[object] = None
    store: Optional[object] = None

    def set_defaults(self) -> None:
        if not self.instance_id:
            self.instance_id = "".join(
                random.choice(string.ascii_lowercase + string.digits)
                for _ in range(10))
        if self.cache_size <= 0:
            self.cache_size = 50_000


@dataclass
class DaemonConfig:
    """Daemon-level config (reference config.go:181-252), standalone."""

    grpc_listen_address: str = "localhost:81"
    http_listen_address: str = "localhost:80"
    advertise_address: str = ""
    config: Config = field(default_factory=Config)
    peer_discovery_type: str = "none"
    log_level: str = "info"
    log_format: str = "text"
    grpc_max_conn_age_sec: int = 0


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
        batch_wait=r.float_seconds("GUBER_BATCH_WAIT", 500e-6),
        batch_limit=r.int_("GUBER_BATCH_LIMIT", DEFAULT_BATCH_LIMIT),
        batch_limit_set=r.has("GUBER_BATCH_LIMIT"),
        force_global=r.bool_("GUBER_FORCE_GLOBAL"),
    )
    conf = Config(
        behaviors=behaviors,
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
    discovery = r.str_("GUBER_PEER_DISCOVERY_TYPE", "none")
    if discovery != "none":
        raise ValueError(
            f"GUBER_PEER_DISCOVERY_TYPE={discovery!r} is not ported yet: "
            f"{_DISCOVERY}; only 'none' (a standalone node) is")

    return DaemonConfig(
        grpc_listen_address=r.str_("GUBER_GRPC_ADDRESS", f"{local_host()}:81"),
        http_listen_address=r.str_("GUBER_HTTP_ADDRESS", f"{local_host()}:80"),
        advertise_address=r.str_("GUBER_ADVERTISE_ADDRESS"),
        config=conf,
        peer_discovery_type=discovery,
        log_level=r.str_("GUBER_LOG_LEVEL", "info"),
        log_format=r.str_("GUBER_LOG_FORMAT", "text"),
        grpc_max_conn_age_sec=r.int_("GUBER_GRPC_MAX_CONN_AGE_SEC", 0),
    )


def local_host() -> str:
    """Bind-address default: 'localhost' unless it does not resolve
    (reference config.go:498-511)."""
    try:
        socket.getaddrinfo("localhost", None)
        return "localhost"
    except OSError:
        return "127.0.0.1"
