"""The port's daemon configuration against the JAX package's.

``setup_daemon_config`` of both packages reads the same ``environ`` dict:
for every ported knob the resulting fields are equal, and invalid values
raise in both.  A knob of a module the port does not have yet raises in
the port, naming the knob, instead of being silently ignored; since the
cluster was ported, its knobs, discovery and TLS are read as the JAX
package reads them.
"""

import dataclasses
import re

import pytest

from gubernator_tpu import config as jconfig
from gubernator_tpu_torch import config

BASE = {"GUBER_INSTANCE_ID": "node-1"}

# A valid, non-default value of every knob setup_daemon_config reads.
PORTED = {
    "GUBER_ADVERTISE_ADDRESS": {"GUBER_ADVERTISE_ADDRESS": "10.1.2.3:81"},
    "GUBER_BATCH_LIMIT": {"GUBER_BATCH_LIMIT": "250"},
    "GUBER_BATCH_LIMIT_default": {"GUBER_BATCH_LIMIT": "1000"},
    "GUBER_BATCH_WAIT": {"GUBER_BATCH_WAIT": "2ms"},
    "GUBER_CACHE_SIZE": {"GUBER_CACHE_SIZE": "4096"},
    "GUBER_COLD_CACHE_SIZE": {"GUBER_COLD_CACHE_SIZE": "512"},
    "GUBER_FORCE_GLOBAL": {"GUBER_FORCE_GLOBAL": "true"},
    "GUBER_GRPC_ADDRESS": {"GUBER_GRPC_ADDRESS": "127.0.0.1:9990"},
    "GUBER_GRPC_MAX_CONN_AGE_SEC": {"GUBER_GRPC_MAX_CONN_AGE_SEC": "30"},
    "GUBER_HTTP_ADDRESS": {"GUBER_HTTP_ADDRESS": "127.0.0.1:9980"},
    "GUBER_INSTANCE_ID": {"GUBER_INSTANCE_ID": "another"},
    "GUBER_LOG_FORMAT": {"GUBER_LOG_FORMAT": "json"},
    "GUBER_LOG_LEVEL": {"GUBER_LOG_LEVEL": "debug"},
    "GUBER_PEER_DISCOVERY_TYPE": {"GUBER_PEER_DISCOVERY_TYPE": "none"},
    "GUBER_SNAPSHOT_DELTAS_PER_BASE": {"GUBER_SNAPSHOT_DELTAS_PER_BASE": "9"},
    "GUBER_SNAPSHOT_DIR": {"GUBER_SNAPSHOT_DIR": "snapshots"},
    "GUBER_SNAPSHOT_INTERVAL": {"GUBER_SNAPSHOT_INTERVAL": "1500ms"},
    "GUBER_SSD": {"GUBER_COLD_CACHE_SIZE": "64", "GUBER_SSD_DIR": "slabs",
                  "GUBER_SSD_CAPACITY_BYTES": "1048576",
                  "GUBER_SSD_COMPACT_RATIO": "0.25",
                  "GUBER_SSD_QUEUE_DEPTH": "3"},
    "GUBER_TPU_BG_RECLAIM": {"GUBER_TPU_BG_RECLAIM": "off"},
    "GUBER_TPU_MAX_BATCH": {"GUBER_TPU_MAX_BATCH": "1024"},
    "GUBER_TPU_MESH_SHARDS": {"GUBER_TPU_MESH_SHARDS": "4"},
    "GUBER_TPU_PLATFORM": {"GUBER_TPU_PLATFORM": "cpu"},
    "GUBER_TPU_GLOBAL_MESH": {"GUBER_TPU_GLOBAL_MESH_NODES": "4",
                              "GUBER_TPU_GLOBAL_MESH_NODE": "2",
                              "GUBER_TPU_GLOBAL_MESH_CAPACITY": "8192"},
    # The cluster, its resilience knobs, discovery and TLS.
    "GUBER_BATCH_TIMEOUT": {"GUBER_BATCH_TIMEOUT": "250ms"},
    "GUBER_DISABLE_BATCHING": {"GUBER_DISABLE_BATCHING": "1"},
    "GUBER_GLOBAL": {"GUBER_GLOBAL_TIMEOUT": "2s",
                     "GUBER_GLOBAL_SYNC_WAIT": "20ms",
                     "GUBER_GLOBAL_BATCH_LIMIT": "77"},
    "GUBER_DATA_CENTER": {"GUBER_DATA_CENTER": "dc-west"},
    "GUBER_DRAIN_TIMEOUT": {"GUBER_DRAIN_TIMEOUT": "750ms"},
    "GUBER_PEER_PICKER": {"GUBER_PEER_PICKER": "replicated-hash",
                          "GUBER_PEER_PICKER_HASH": "fnv1a",
                          "GUBER_REPLICATED_HASH_REPLICAS": "64"},
    "GUBER_BREAKER": {"GUBER_BREAKER_ENABLED": "0",
                      "GUBER_BREAKER_FAILURE_THRESHOLD": "0.25",
                      "GUBER_BREAKER_MIN_REQUESTS": "9",
                      "GUBER_BREAKER_WINDOW": "3s",
                      "GUBER_BREAKER_OPEN_FOR": "500ms",
                      "GUBER_BREAKER_OPEN_CAP": "5s",
                      "GUBER_BREAKER_HALF_OPEN_PROBES": "3"},
    "GUBER_FORWARD": {"GUBER_FORWARD_MAX_ATTEMPTS": "2",
                      "GUBER_FORWARD_BACKOFF_BASE": "1ms",
                      "GUBER_FORWARD_BACKOFF_CAP": "50ms",
                      "GUBER_REDELIVERY_LIMIT": "123"},
    "GUBER_MEMBERLIST": {"GUBER_PEER_DISCOVERY_TYPE": "member-list",
                         "GUBER_MEMBERLIST_ADDRESS": "0.0.0.0:7946",
                         "GUBER_MEMBERLIST_ADVERTISE_ADDRESS": "10.0.0.5:7946",
                         "GUBER_MEMBERLIST_KNOWN_NODES": "a:7946, b:7946"},
    "GUBER_ETCD": {"GUBER_PEER_DISCOVERY_TYPE": "etcd",
                   "GUBER_ETCD_ENDPOINTS": "e1:2379,e2:2379",
                   "GUBER_ETCD_KEY_PREFIX": "/p/", "GUBER_ETCD_USER": "u",
                   "GUBER_ETCD_PASSWORD": "pw",
                   "GUBER_ETCD_DIAL_TIMEOUT": "2s"},
    "GUBER_K8S": {"GUBER_PEER_DISCOVERY_TYPE": "k8s",
                  "GUBER_K8S_NAMESPACE": "ns", "GUBER_K8S_POD_IP": "10.2.3.4",
                  "GUBER_K8S_POD_PORT": "81",
                  "GUBER_K8S_ENDPOINTS_SELECTOR": "app=guber",
                  "GUBER_K8S_WATCH_MECHANISM": "pods"},
    "GUBER_DNS": {"GUBER_PEER_DISCOVERY_TYPE": "dns",
                  "GUBER_DNS_FQDN": "guber.svc", "GUBER_RESOLV_CONF": "rc"},
    "GUBER_TLS": {"GUBER_TLS_CA": "ca.pem", "GUBER_TLS_CA_KEY": "ca.key",
                  "GUBER_TLS_CERT": "c.pem", "GUBER_TLS_KEY": "c.key",
                  "GUBER_TLS_AUTO": "1",
                  "GUBER_TLS_CLIENT_AUTH": "require-and-verify",
                  "GUBER_TLS_CLIENT_AUTH_CA_CERT": "cca.pem",
                  "GUBER_TLS_CLIENT_AUTH_CERT": "cc.pem",
                  "GUBER_TLS_CLIENT_AUTH_KEY": "cc.key",
                  "GUBER_TLS_CLIENT_AUTH_SERVER_NAME": "guber",
                  "GUBER_TLS_INSECURE_SKIP_VERIFY": "1",
                  "GUBER_TLS_MIN_VERSION": "1.2",
                  "GUBER_STATUS_HTTP_ADDRESS": "127.0.0.1:9981"},
}

# Values both packages refuse.
INVALID = [
    {"GUBER_TPU_BG_RECLAIM": "maybe"},
    {"GUBER_COLD_CACHE_SIZE": "-1"},
    {"GUBER_SSD_DIR": "slabs"},
    {"GUBER_COLD_CACHE_SIZE": "8", "GUBER_SSD_DIR": "s",
     "GUBER_TPU_MESH_SHARDS": "2"},
    {"GUBER_COLD_CACHE_SIZE": "8", "GUBER_SSD_DIR": "s",
     "GUBER_SSD_COMPACT_RATIO": "1.5"},
    {"GUBER_COLD_CACHE_SIZE": "8", "GUBER_SSD_DIR": "s",
     "GUBER_SSD_QUEUE_DEPTH": "0"},
    {"GUBER_COLD_CACHE_SIZE": "8", "GUBER_SSD_DIR": "s",
     "GUBER_SSD_CAPACITY_BYTES": "0"},
    {"GUBER_SNAPSHOT_INTERVAL": "0"},
    {"GUBER_SNAPSHOT_DELTAS_PER_BASE": "0"},
    {"GUBER_CACHE_SIZE": "lots"},
    {"GUBER_BATCH_WAIT": "soon"},
    {"GUBER_DRAIN_TIMEOUT": "-1"},
    {"GUBER_BREAKER_FAILURE_THRESHOLD": "0"},
    {"GUBER_FORWARD_MAX_ATTEMPTS": "-1"},
    {"GUBER_REDELIVERY_LIMIT": "-2"},
    {"GUBER_PEER_PICKER_HASH": "md5"},
    {"GUBER_PEER_PICKER": "round-robin"},
    {"GUBER_PEER_DISCOVERY_TYPE": "consul"},
    {"GUBER_TPU_GLOBAL_MESH_CAPACITY": str((1 << 24) + 1)},
    {"GUBER_TPU_GLOBAL_MESH_NODES": "many"},
]


def same_fields(a, b):
    """Every field of the port's dataclass equals the JAX one's."""
    for f in dataclasses.fields(b):
        if f.name in ("loader", "store", "fault_injector"):
            continue  # objects of each package's own classes
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(vb):
            same_fields(va, vb)
        else:
            assert va == vb, f.name


def test_every_ported_knob_sets_the_fields_the_jax_config_sets():
    for knob, values in PORTED.items():
        env = {**BASE, **values}
        a = jconfig.setup_daemon_config(environ=env)
        b = config.setup_daemon_config(environ=env)
        same_fields(a, b)
    everything = {**BASE}
    for values in PORTED.values():
        everything.update(values)
    everything["GUBER_TPU_MESH_SHARDS"] = "0"  # the SSD tier is single-card
    same_fields(jconfig.setup_daemon_config(environ=everything),
                config.setup_daemon_config(environ=everything))


def test_config_file_loads_as_in_the_jax_package(tmp_path):
    path = tmp_path / "node.conf"
    path.write_text("# a comment\nGUBER_CACHE_SIZE = 2048\n\n"
                    "GUBER_BATCH_WAIT=1ms\nGUBER_INSTANCE_ID=x\n")
    env = {"GUBER_BATCH_WAIT": "3ms"}  # the environment wins
    a = jconfig.setup_daemon_config(str(path), environ=env)
    b = config.setup_daemon_config(str(path), environ=env)
    same_fields(a, b)
    assert b.config.cache_size == 2048 and b.config.behaviors.batch_wait == 0.003
    bad = tmp_path / "bad.conf"
    bad.write_text("GUBER_CACHE_SIZE\n")
    with pytest.raises(ValueError):
        config.setup_daemon_config(str(bad), environ={})


def test_invalid_values_raise_in_both():
    for env in INVALID:
        env = {**BASE, **env}
        with pytest.raises(ValueError):
            jconfig.setup_daemon_config(environ=env)
        with pytest.raises(ValueError):
            config.setup_daemon_config(environ=env)


def test_every_reference_knob_is_ported_or_refused():
    ref = set(jconfig.ENV_REGISTRY)
    assert set(config.ENV_REGISTRY) | set(config.UNPORTED) == ref
    assert not set(config.ENV_REGISTRY) & set(config.UNPORTED)


@pytest.mark.parametrize("what", sorted(set(config.UNPORTED.values())))
def test_unported_knobs_raise_naming_themselves(what):
    knobs = [k for k, v in config.UNPORTED.items() if v == what]
    for knob in knobs:
        with pytest.raises(ValueError,
                           match=re.escape(knob) + ".*not ported"):
            config.setup_daemon_config(environ={**BASE, knob: "1"})


def test_discovery_other_than_none_raises():
    """Every discovery pool of the JAX package is ported: each of the
    four besides ``none`` sets the fields the JAX config sets, and a type
    outside the five raises in both, naming the knob."""
    for kind in ("dns", "etcd", "k8s", "member-list"):
        env = {**BASE, "GUBER_PEER_DISCOVERY_TYPE": kind}
        a = jconfig.setup_daemon_config(environ=env)
        b = config.setup_daemon_config(environ=env)
        same_fields(a, b)
        assert b.peer_discovery_type == kind
    assert config.DISCOVERY_TYPES == jconfig.DISCOVERY_TYPES
    env = {**BASE, "GUBER_PEER_DISCOVERY_TYPE": "consul"}
    with pytest.raises(ValueError, match="GUBER_PEER_DISCOVERY_TYPE"):
        jconfig.setup_daemon_config(environ=env)
    with pytest.raises(ValueError, match="GUBER_PEER_DISCOVERY_TYPE"):
        config.setup_daemon_config(environ=env)


def test_fault_knobs_build_the_jax_packages_injector():
    """GUBER_FAULT_* build the same schedule in both packages, and none
    without a target peer."""
    env = {**BASE, "GUBER_FAULT_PEERS": "10.0.0.1:81, *",
           "GUBER_FAULT_ERROR_RATE": "0.25", "GUBER_FAULT_DROP_RATE": "0.5",
           "GUBER_FAULT_DELAY": "5ms", "GUBER_FAULT_PARTITION": "1",
           "GUBER_FAULT_SEED": "42"}
    a = jconfig.setup_daemon_config(environ=env).config.fault_injector
    b = config.setup_daemon_config(environ=env).config.fault_injector
    assert sorted(b._faults) == sorted(a._faults) == ["*", "10.0.0.1:81"]
    for peer in a._faults:
        assert vars(b._faults[peer]) == vars(a._faults[peer])
    assert b._rng.getstate() == a._rng.getstate()
    assert config.setup_daemon_config(
        environ=BASE).config.fault_injector is None


def test_env_knob_reads_only_ported_knobs():
    env = {"GUBER_TICK_PIPELINE_DEPTH": "7", "GUBER_SLOW_WINDOW_MS": "x"}
    assert config.env_knob("GUBER_TICK_PIPELINE_DEPTH", 4, int, env) == 7
    assert config.env_knob("GUBER_INGEST_ARENA_SLABS", 8, int, env) == 8
    with pytest.raises(ValueError, match="GUBER_SLOW_WINDOW_MS"):
        config.env_knob("GUBER_SLOW_WINDOW_MS", 0.0, float, env)
    with pytest.raises(KeyError):
        config.env_knob("GUBER_EDGE_WORKERS", None, None, env)
    assert config.env_knob("GUBER_PEER_TIMEOUT_FLOOR", 0.05,
                           config.parse_duration, env) == 0.05
    for value in ("250ms", "2s", "1m", "100us", "0.5"):
        assert config.parse_duration(value) == jconfig.parse_duration(value)


def test_global_mesh_capacity_guard(caplog):
    """The reference's guard (tests/test_config.py:124-161): silent in the
    envelope, a warning past 2^20, refused past 2^24, by the config
    surface and by the engine's constructor."""
    import logging

    from gubernator_tpu_torch.parallel.global_mesh import MeshGlobalEngine

    assert (config.GLOBAL_MESH_CAPACITY_SOFT,
            config.GLOBAL_MESH_CAPACITY_HARD) == (
        jconfig.GLOBAL_MESH_CAPACITY_SOFT, jconfig.GLOBAL_MESH_CAPACITY_HARD)
    env = {**BASE, "GUBER_TPU_GLOBAL_MESH_CAPACITY": str(1 << 16)}
    with caplog.at_level(logging.WARNING, logger="gubernator"):
        config.setup_daemon_config(environ=env)
    assert "GLOBAL_MESH_CAPACITY" not in caplog.text
    soft = config.GLOBAL_MESH_CAPACITY_SOFT * 2
    env["GUBER_TPU_GLOBAL_MESH_CAPACITY"] = str(soft)
    with caplog.at_level(logging.WARNING, logger="gubernator"):
        c = config.setup_daemon_config(environ=env)
    assert c.config.tpu_global_mesh_capacity == soft
    assert "GLOBAL_MESH_CAPACITY" in caplog.text
    env["GUBER_TPU_GLOBAL_MESH_CAPACITY"] = str(
        config.GLOBAL_MESH_CAPACITY_HARD * 2)
    with pytest.raises(ValueError, match="GLOBAL_MESH_CAPACITY"):
        config.setup_daemon_config(environ=env)
    with pytest.raises(ValueError, match="GLOBAL_MESH_CAPACITY"):
        MeshGlobalEngine(n_nodes=2,
                         capacity=config.GLOBAL_MESH_CAPACITY_HARD * 2,
                         device="cpu")
