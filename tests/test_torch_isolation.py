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
from gubernator_tpu_torch.ops.raggedtick import fused_ragged_tick
from gubernator_tpu_torch.ops.sortedtick import fused_sorted_tick
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
            "gubernator_tpu_torch.resilience.supervisor"} <= set(mods)
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
    assert gt.kernel_launches() == {
        "fused_tick": 0, "fused_merged_tick": 0, "fused_ragged_tick": 0,
        "fused_sorted_tick": 0, "gather_rows": 0, "scatter_rows": 0}


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
