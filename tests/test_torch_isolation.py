"""The port stands alone and runs on the card unless asked not to.

* Importing every module of ``gubernator_tpu_torch`` loads neither ``jax``
  nor any module of the JAX package (checked in a fresh interpreter), and
  no source file of the port names either in an import.
* With no CUDA device, entry points that were given no device raise
  instead of falling back to the CPU.
* CPU tensors go through the plain versions and leave every kernel's
  launch counter at 0.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import gubernator_tpu_torch as gt
from gubernator_tpu_torch.carry import table_from_columns
from gubernator_tpu_torch.ops import rowtable
from gubernator_tpu_torch.ops.engine import TickEngine
from gubernator_tpu_torch.ops.fusedtick import fused_tick
from gubernator_tpu_torch.ops.leasecols import lease_apply
from gubernator_tpu_torch.ops.raggedtick import fused_ragged_tick
from gubernator_tpu_torch.ops.sortedtick import fused_sorted_tick
from gubernator_tpu_torch.parallel.global_mesh import MeshGlobalEngine
from gubernator_tpu_torch.parallel.mesh_engine import MeshTickEngine
from gubernator_tpu_torch.types import (
    GlobalUpdate, RateLimitRequest, RateLimitResponse)

PKG_DIR = os.path.dirname(gt.__file__)
REPO = os.path.dirname(PKG_DIR)


def _modules():
    names = [gt.__name__]
    for info in pkgutil.walk_packages([PKG_DIR], prefix=gt.__name__ + "."):
        names.append(info.name)
    return names


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "jaxlib" or name.startswith("jaxlib.")
            or name == "gubernator_tpu" or name.startswith("gubernator_tpu."))


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _modules()
    assert {"gubernator_tpu_torch.ops.engine", "gubernator_tpu_torch.carry",
            "gubernator_tpu_torch.native",
            "gubernator_tpu_torch.algos.gcra",
            "gubernator_tpu_torch.ops.raggedtick",
            "gubernator_tpu_torch.ops.sortedtick",
            "gubernator_tpu_torch.ops.snapshot",
            "gubernator_tpu_torch.parallel.partition",
            "gubernator_tpu_torch.parallel.mesh_engine",
            "gubernator_tpu_torch.store",
            "gubernator_tpu_torch.tiering.coldstore",
            "gubernator_tpu_torch.tiering.ssd",
            "gubernator_tpu_torch.persistence.snapshot",
            "gubernator_tpu_torch.persistence.writer",
            "gubernator_tpu_torch.persistence.transition",
            "gubernator_tpu_torch.resilience.supervisor",
            "gubernator_tpu_torch.resilience.breaker",
            "gubernator_tpu_torch.resilience.faults",
            "gubernator_tpu_torch.parallel.hashring",
            "gubernator_tpu_torch.service.peer_client",
            "gubernator_tpu_torch.service.global_manager",
            "gubernator_tpu_torch.discovery.gossip",
            "gubernator_tpu_torch.discovery.etcdpool",
            "gubernator_tpu_torch.discovery.k8spool",
            "gubernator_tpu_torch.discovery.dnspool",
            "gubernator_tpu_torch.transport.tlsutil",
            "gubernator_tpu_torch.cluster",
            "gubernator_tpu_torch.cmd.cluster_main",
            "gubernator_tpu_torch.leases",
            "gubernator_tpu_torch.leases.protocol",
            "gubernator_tpu_torch.leases.signing",
            "gubernator_tpu_torch.leases.cache",
            "gubernator_tpu_torch.leases.manager",
            "gubernator_tpu_torch.ops.leasecols",
            "gubernator_tpu_torch.client",
            "gubernator_tpu_torch.cmd.cli",
            "gubernator_tpu_torch.cmd.healthcheck",
            "gubernator_tpu_torch.ops.globalmesh",
            "gubernator_tpu_torch.parallel.global_mesh"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'gubernator_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'gubernator_tpu.')))\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_file_imports_jax_or_the_jax_package():
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                assert not any(_forbidden(n) for n in names), (path, names)


def test_no_device_means_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal "
                    "without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gt.default_device()
    with pytest.raises(RuntimeError):
        TickEngine(capacity=16, max_batch=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MeshTickEngine(n_shards=2, local_capacity=8, max_batch=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MeshGlobalEngine(n_nodes=2, capacity=16)
    with pytest.raises(RuntimeError):
        table_from_columns({"limit": np.zeros(2, np.int64)}, 4)
    assert gt.resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_take_the_plain_paths_and_launch_no_kernel():
    gt.reset_kernel_launches()
    eng = TickEngine(capacity=32, max_batch=16, device="cpu")
    reqs = [RateLimitRequest(name="iso", unique_key=f"k{i % 6}", hits=1,
                             limit=3, duration=60_000, algorithm=i % 5)
            for i in range(20)]
    resp = eng.process(reqs, now=1_700_000_000_000)
    assert len(resp) == 20 and eng.metric_rank_rounds > 0
    assert eng.metric_sorted_ticks == 1
    # State movement: an install, a lease window, an export and a load.
    eng.install_globals([GlobalUpdate(
        key="iso_g", status=RateLimitResponse(limit=5, remaining=4,
                                              reset_time=1_700_000_060_000))],
        now=1_700_000_000_000)
    assert eng.lease_window([b"iso_g"], [3], [1_700_000_001_000], [1]) == 1
    TickEngine(capacity=32, max_batch=16, device="cpu").load_columns(
        eng.export_columns(), now=1_700_000_000_000)
    # Fill the table so a reclaim runs the gather and the evict scatter.
    more = [RateLimitRequest(name="iso", unique_key=f"f{i}", hits=1,
                             limit=3, duration=60_000) for i in range(40)]
    eng.process(more[:16], now=1_700_000_000_001)
    eng.process(more[16:32], now=1_700_000_000_002)
    eng.process(more[32:], now=1_700_000_000_003)
    assert eng.metric_unexpired_evictions > 0
    table = eng.table
    assert table.device.type == "cpu"
    fused_tick(table, torch.zeros((19, 8), dtype=torch.int32), 0)
    rowtable.gather_rows(table, torch.arange(4))
    herd = [RateLimitRequest(name="iso", unique_key=f"h{i % 3}", hits=1,
                             limit=3, duration=60_000) for i in range(12)]
    eng.process(herd, now=1_700_000_000_004)
    assert eng.metric_grouped_ticks == 1
    mesh = MeshTickEngine(n_shards=2, local_capacity=8, max_batch=16,
                          device="cpu")
    mesh.process(reqs[:16], now=1_700_000_000_005)     # repeats: merge tick
    mesh.process(more[:16], now=1_700_000_000_006)     # unique: ragged tick
    assert mesh.metric_rank_rounds > 0
    assert mesh.metric_unexpired_evictions > 0
    # The GLOBAL mesh: a window with repeats (the chained tick), a sparse
    # step and an overflowing one (the dense fallback), and an eviction.
    gmesh = MeshGlobalEngine(n_nodes=2, capacity=16, max_batch=16,
                             sparse_k=2, device="cpu")
    greqs = [RateLimitRequest(name="iso", unique_key=f"g{i % 5}", hits=1,
                              limit=3, duration=60_000, behavior=2)
             for i in range(8)]
    gmesh.process_blocks([greqs[:2], greqs[2:4]], now=1_700_000_000_007)
    gmesh.reconcile(now=1_700_000_000_008)
    gmesh.process_blocks([greqs, greqs], now=1_700_000_000_009)
    gmesh.reconcile(now=1_700_000_000_010)
    gmesh.evict(np.array([0]))
    assert gmesh.metric_sorted_windows == 1
    assert gmesh.metric_dense_fallbacks == 1
    assert gt.kernel_launches() == {
        "fused_tick": 0, "fused_merged_tick": 0, "fused_ragged_tick": 0,
        "fused_sorted_tick": 0, "mesh_tile_tick": 0, "gather_rows": 0,
        "scatter_rows": 0, "lease_apply": 0, "global_accumulate": 0,
        "global_dense_reconcile": 0, "global_sparse_probe": 0,
        "global_sparse_apply": 0}


def test_wrappers_refuse_tensors_on_other_devices():
    table = torch.zeros((9, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        rowtable.gather_rows(table, torch.zeros(2, dtype=torch.int64,
                                                device="meta"))
    with pytest.raises(ValueError):
        fused_tick(table, torch.zeros((19, 4), dtype=torch.int32,
                                      device="meta"), 0)
    with pytest.raises(ValueError):
        fused_ragged_tick(table, torch.zeros((19, 4), dtype=torch.int32,
                                             device="meta"),
                          torch.zeros(2, dtype=torch.int32, device="meta"),
                          1, 8, 0)
    with pytest.raises(ValueError):
        fused_sorted_tick(table, torch.zeros((19, 4), dtype=torch.int32,
                                             device="meta"), 0)
    col = torch.zeros(9, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        lease_apply(col, col.clone(), col.to(torch.int32),
                    torch.zeros((4, 2), dtype=torch.int64, device="meta"),
                    True)


SERVING_CORE = (
    "types", "ops.reqcols", "config", "admission", "admission.deadline",
    "admission.limiter", "admission.queue", "utils.flightrec",
    "utils.tracing", "utils.metrics", "service.tickloop",
    "service.instance", "transport.wire", "transport.fastwire",
    "parallel.hashring", "resilience", "service.global_manager",
    "leases", "ops.leasecols",
)


def test_serving_core_runs_without_grpc_protobuf_aiohttp_or_prometheus():
    """With grpc, google.protobuf, aiohttp and prometheus_client
    unimportable, the serving core (with the cluster's ring, breakers and
    GLOBAL manager) imports and serves a wire batch on a CPU instance;
    only pb/, convert, grpc_api, the peer client, tlsutil, discovery,
    daemon, cluster and the cmd entry points need them."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('grpc', 'aiohttp', "
        "'prometheus_client') or name.startswith('google.protobuf'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import asyncio, importlib\n"
        f"for m in {SERVING_CORE!r}:\n"
        "    importlib.import_module('gubernator_tpu_torch.' + m)\n"
        "from gubernator_tpu_torch.ops.reqcols import ReqColumns\n"
        "from gubernator_tpu_torch.service.instance import (\n"
        "    InstanceConfig, V1Instance)\n"
        "from gubernator_tpu_torch.transport import fastwire\n"
        "from gubernator_tpu_torch.types import RateLimitRequest\n"
        "async def main():\n"
        "    inst = await V1Instance.create(InstanceConfig(\n"
        "        cache_size=64, tpu_max_batch=16, tpu_platform='cpu'))\n"
        "    raw = fastwire.encode_req(ReqColumns.from_requests([\n"
        "        RateLimitRequest(name='a', unique_key=str(i), hits=1,\n"
        "                         limit=5, duration=60_000)\n"
        "        for i in range(3)]))\n"
        "    cols, errs, special = fastwire.parse_req(raw, inst.ingest_arena)\n"
        "    mat, errs = await inst.get_rate_limits_columns(cols)\n"
        "    fastwire.encode_resp(mat)\n"
        "    inst.metrics.expose()\n"
        "    await inst.close()\n"
        "    print(mat[2].tolist())\n"
        "asyncio.run(main())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in (\n"
        "    'grpc', 'aiohttp', 'prometheus_client') or\n"
        "    m.startswith('google.protobuf'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[4, 4, 4]", "[]"]


def test_instance_and_daemon_without_a_platform_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal "
                    "without one")
    import asyncio

    from gubernator_tpu_torch import config
    from gubernator_tpu_torch.service.instance import (
        InstanceConfig, V1Instance)
    from gubernator_tpu_torch.transport.daemon import Daemon, spawn_daemon

    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyncio.run(V1Instance.create(
            InstanceConfig(cache_size=16, tpu_max_batch=8)))
    conf = config.DaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
        config=config.Config(cache_size=16, tpu_max_batch=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyncio.run(spawn_daemon(conf))
    with pytest.raises(ValueError, match="discovery"):
        Daemon(config.DaemonConfig(peer_discovery_type="consul"))
    from gubernator_tpu_torch.cluster import Cluster

    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyncio.run(Cluster.start(1, global_mesh=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyncio.run(Cluster.start(1))
    with pytest.raises(ValueError, match="GUBER_SSD_DIR is not supported"):
        asyncio.run(V1Instance.create(InstanceConfig(
            cache_size=16, tpu_max_batch=8, tpu_mesh_shards=2,
            tpu_platform="cpu", cold_cache_size=4, ssd_dir="/nonexistent")))
