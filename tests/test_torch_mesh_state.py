"""The port's MeshTickEngine state paths (device="cpu", 4 shards) against
the JAX package's MeshTickEngine on a 4-device CPU mesh, and a
``V1Instance`` with ``tpu_mesh_shards=2`` against the JAX node.

Both engines carry a recording Store and take, in order: Store windows
(read-through of persisted keys, write-through, remove-on-reset, a batch
wider than ``max_batch``), GLOBAL installs (the last update of a key wins,
a shard too full for them), ``export_items``, ``load_items`` (expired
items, repeated keys, a shard too full for them) and a round trip into
fresh meshes.  After each step the answers, the Store's call sequences,
every live key's global slot and row, and the counters are equal, and
every shard's guard row is zero.  The shapes are ``test_torch_mesh.py``'s,
so the JAX engine compiles no new program shape.  Leaky pairs come from
the exact-quotient pool (ROADMAP C.1).
"""

import asyncio
import logging
import zlib

import numpy as np
import pytest
import torch

import jax

from gubernator_tpu.parallel.mesh_engine import (
    MeshTickEngine as JaxMesh, make_mesh)
from gubernator_tpu import store as jstore
from gubernator_tpu import types as jtypes
from gubernator_tpu.service import instance as jinstance
from gubernator_tpu.utils import timeutil as jtimeutil
from gubernator_tpu_torch import store as tstore
from gubernator_tpu_torch import types as ttypes
from gubernator_tpu_torch.cluster import Cluster, _daemon_config, wait_quiet
from gubernator_tpu_torch.config import BehaviorConfig
from gubernator_tpu_torch.ops import engine as E
from gubernator_tpu_torch.ops import rowtable
from gubernator_tpu_torch.parallel.mesh_engine import MeshTickEngine
from gubernator_tpu_torch.service import instance as tinstance
from gubernator_tpu_torch.transport.daemon import Daemon
from gubernator_tpu_torch.types import Behavior
from gubernator_tpu_torch.utils import timeutil
from tests.test_torch_common import EXACT_DL, NOW
from tests.test_torch_mesh import (
    COUNTERS, LC, MB, N_SHARDS, jax_state, port_state)

RESET = int(Behavior.RESET_REMAINING)
GLOBAL = int(Behavior.GLOBAL)
STORE_COUNTERS = ("metric_hits", "metric_misses",
                  "metric_unexpired_evictions")


def recording(base):
    """``base`` (either package's MockStore) logging every call in
    order."""
    class Recording(base):
        def __init__(self):
            super().__init__()
            self.log = []

        def on_change(self, req, item):
            self.log.append(("on_change", req.hash_key(), dict(item)))
            super().on_change(req, item)

        def get(self, req):
            self.log.append(("get", req.hash_key()))
            return super().get(req)

        def remove(self, key):
            self.log.append(("remove", key))
            super().remove(key)
    return Recording


JStore, TStore = recording(jstore.MockStore), recording(tstore.MockStore)


@pytest.fixture(scope="module")
def engines():
    jeng = JaxMesh(mesh=make_mesh(jax.devices()[:N_SHARDS]),
                   local_capacity=LC, max_batch=MB, store=JStore())
    teng = MeshTickEngine(n_shards=N_SHARDS, local_capacity=LC,
                          max_batch=MB, device="cpu", store=TStore())
    return jeng, teng


def shard_of(key: str) -> int:
    return zlib.crc32(key.encode()) % N_SHARDS


def keys_on(shards, count, prefix):
    """``count`` unique keys (``ms_<prefix><i>`` hash keys) whose route
    lands in ``shards``."""
    out, i = [], 0
    while len(out) < count:
        k = f"{prefix}{i}"
        if shard_of("ms_" + k) in shards:
            out.append(k)
        i += 1
    return out


def requests(rng, keys, reset=0.0):
    """Matching JAX and port request objects over ``keys``: every
    algorithm, exact leaky pairs, RESET rows at rate ``reset``."""
    pairs = []
    for k in keys:
        d, lim = EXACT_DL[int(rng.integers(len(EXACT_DL)))]
        kw = dict(name="ms", unique_key=k,
                  hits=int(rng.choice([0, 1, 2, 5])), limit=lim, duration=d,
                  algorithm=int(rng.integers(0, 5)),
                  behavior=RESET if rng.random() < reset else 0,
                  burst=int(rng.choice([0, 5, 20])))
        pairs.append((jtypes.RateLimitRequest(**kw),
                      ttypes.RateLimitRequest(**kw)))
    return [p[0] for p in pairs], [p[1] for p in pairs]


def stored_item(rng, key, now):
    d, lim = EXACT_DL[int(rng.integers(1, len(EXACT_DL)))]
    return {"key": "ms_" + key, "algorithm": int(rng.integers(0, 2)),
            "limit": lim, "remaining": int(rng.integers(0, lim + 1)),
            "remaining_f": float(rng.integers(0, lim + 1)), "duration": d,
            "created_at": now - 1_000, "updated_at": now - 1_000,
            "burst": lim, "status": 0, "expire_at": now + 600_000}


def answers(resps):
    return [(r.status, r.limit, r.remaining, r.reset_time, r.error)
            for r in resps]


def assert_guard_rows_zero(teng):
    guards = teng.table[teng.local_capacity::teng.local_capacity + 1]
    assert guards.shape[0] == teng.n_shards
    assert (guards == 0).all()


def assert_same(jeng, teng, counters=STORE_COUNTERS):
    assert port_state(teng) == jax_state(jeng)
    for c in counters:
        assert getattr(teng, c) == getattr(jeng, c), c
    assert teng.store.log == jeng.store.log
    assert teng.store.data == jeng.store.data
    assert_guard_rows_zero(teng)


def process(jeng, teng, jreqs, treqs, now):
    want = answers(jeng.process(jreqs, now))
    got = answers(teng.process(treqs, now))
    assert got == want
    return got


# ----------------------------------------------------------------------
# The Store
# ----------------------------------------------------------------------
def test_store_windows_match_jax(engines):
    """Persisted keys read through before the tick, every touched key
    writes through after it (once a slot, shards in the order the window
    touches them), RESET rows remove their key, repeats in a window tick
    in order."""
    jeng, teng = engines
    rng = np.random.default_rng(61)
    pool = keys_on(range(N_SHARDS), 48, "s")
    now = NOW
    for k in pool[:20]:
        item = stored_item(rng, k, now)
        jeng.store.data[item["key"]] = dict(item)
        teng.store.data[item["key"]] = dict(item)
    for step in range(5):
        now += 1_000 * int(rng.integers(1, 4))
        ids = (rng.permutation(len(pool))[:40] if step % 2 == 0
               else rng.integers(0, 24, MB))
        process(jeng, teng, *requests(rng, [pool[i] for i in ids],
                                      reset=0.15), now)
    ops = {op for op, *_ in teng.store.log}
    assert ops == {"get", "on_change", "remove"}
    assert_same(jeng, teng, STORE_COUNTERS + COUNTERS[2:])


def test_store_read_through_for_spilled_rows(engines):
    """A batch wider than ``max_batch`` ticks as two windows: the persisted
    keys that spill into the second window read through too, and every
    answer is the persisted count less this hit."""
    jeng, teng = engines
    rng = np.random.default_rng(62)
    now = NOW + 30_000
    fresh = keys_on({0}, 4, "sp")
    for k in fresh:
        item = dict(stored_item(rng, k, now), algorithm=0, limit=10,
                    remaining=3, duration=60_000)
        jeng.store.data[item["key"]] = dict(item)
        teng.store.data[item["key"]] = dict(item)
    filler = keys_on({1, 2, 3}, 1, "spf") * MB
    jreqs, treqs = requests(rng, filler)
    for j, t in zip(jreqs, treqs):
        j.hits = t.hits = 0
    jr, tr = requests(rng, fresh)
    for j, t in zip(jr, tr):
        j.algorithm = t.algorithm = 0
        j.limit = t.limit = 10
        j.duration = t.duration = 60_000
        j.hits = t.hits = 1
        j.behavior = t.behavior = 0
    got = process(jeng, teng, jreqs + jr, treqs + tr, now)
    assert [r[2] for r in got[MB:]] == [2, 2, 2, 2]
    assert_same(jeng, teng)


def test_read_through_needs_request_objects():
    from gubernator_tpu_torch.ops.reqcols import ReqColumns

    teng = MeshTickEngine(n_shards=2, local_capacity=8, max_batch=8,
                          device="cpu", store=TStore())
    cols = ReqColumns.from_requests(
        requests(np.random.default_rng(63), ["nr0", "nr1"])[1])
    with pytest.raises(ValueError, match="keep_refs"):
        teng.process_columns(cols, NOW + 40_000)


# ----------------------------------------------------------------------
# GLOBAL installs
# ----------------------------------------------------------------------
def global_updates(rng, keys, now):
    """Matching JAX and port GlobalUpdates, token and leaky, over
    ``keys`` (repeats allowed)."""
    out = []
    for k in keys:
        d, lim = EXACT_DL[int(rng.integers(1, len(EXACT_DL)))]
        kw = dict(key="ms_" + k, algorithm=int(rng.integers(0, 2)),
                  duration=d)
        st = dict(limit=lim, remaining=int(rng.integers(0, lim + 1)),
                  status=int(rng.integers(0, 2)),
                  reset_time=now + int(rng.integers(1_000, 60_000)))
        out.append((
            jtypes.GlobalUpdate(status=jtypes.RateLimitResponse(**st), **kw),
            ttypes.GlobalUpdate(status=ttypes.RateLimitResponse(**st), **kw)))
    return [u[0] for u in out], [u[1] for u in out]


def counting_scatters(monkeypatch, calls):
    """Record every scatter's flat slots (the wrapper is called on CPU
    tensors too; it then runs its plain version)."""
    orig = rowtable.scatter_rows

    def scatter(table, slots, rows):
        calls.append(slots.clone())
        return orig(table, slots, rows)
    monkeypatch.setattr(rowtable, "scatter_rows", scatter)


def test_installs_match_jax_in_one_scatter_a_chunk(engines, monkeypatch):
    """Installs over every shard, some keys repeated (the last update
    wins) and some already live: all shards' rows land in one scatter a
    STATE_CHUNK (here 8 rows), none aimed at a guard row, and the
    installed keys answer their installed state."""
    jeng, teng = engines
    rng = np.random.default_rng(64)
    now = NOW + 50_000
    pool = keys_on(range(N_SHARDS), 14, "g") + keys_on(range(N_SHARDS), 6, "s")
    keys = [pool[i] for i in rng.integers(0, len(pool), 30)]
    ju, tu = global_updates(rng, keys, now)
    calls = []
    counting_scatters(monkeypatch, calls)
    monkeypatch.setattr(E, "STATE_CHUNK", 8)
    jeng.install_globals(ju, now)
    teng.install_globals(tu, now)
    n = len(set(keys))
    assert [len(c) for c in calls] == [8] * (n // 8) + (
        [n % 8] if n % 8 else [])
    flat = torch.cat(calls)
    assert (flat % (LC + 1) != LC).all()        # no guard row
    assert len(torch.unique(flat)) == n
    assert len({int(f) // (LC + 1) for f in flat}) == N_SHARDS
    monkeypatch.undo()
    assert_same(jeng, teng)
    process(jeng, teng, *requests(rng, sorted(set(keys))), now + 10)
    assert_same(jeng, teng)


def test_installs_into_a_full_shard_match_jax(engines):
    """Shard 1 full of keys touched earlier, then more new installed keys
    than it holds: each key that does not fit reclaims first, keys
    installed in this call are never the victims, the rest are
    dropped."""
    jeng, teng = engines
    rng = np.random.default_rng(65)
    now = NOW + 60_000
    fill = keys_on({1}, LC, "f")
    for a in range(0, LC, 16):
        process(jeng, teng, *requests(rng, fill[a:a + 16]), now + a)
    ju, tu = global_updates(rng, keys_on({1}, LC + 8, "gf"), now + 100)
    ev = teng.metric_unexpired_evictions
    jeng.install_globals(ju, now + 100)
    teng.install_globals(tu, now + 100)
    assert teng.metric_unexpired_evictions > ev
    assert_same(jeng, teng)


# ----------------------------------------------------------------------
# Items out and in
# ----------------------------------------------------------------------
def test_export_items_match_jax(engines):
    jeng, teng = engines
    got = teng.export_items()
    assert got == jeng.export_items()
    assert len(got) == teng.cache_size() > 50


def test_load_items_match_jax(engines, monkeypatch):
    """Items with expired ones, a key that repeats (its last item wins)
    and more new keys on shard 2 than it holds (a reclaim, then the rest
    dropped), loaded into the live engines; then a Store window over the
    loaded keys."""
    jeng, teng = engines
    rng = np.random.default_rng(66)
    now = NOW + 80_000
    items = teng.export_items()[::2]
    for it in items[::3]:
        it["expire_at"] = now - 1                  # expired: dropped
    fresh = keys_on({2}, LC + 6, "ld")
    items += [dict(stored_item(rng, k, now), remaining=i % 7)
              for i, k in enumerate(fresh)]
    items += [dict(it, remaining=it["remaining"] + 1)
              for it in items[-10:]]               # repeats: last wins
    calls = []
    counting_scatters(monkeypatch, calls)
    jeng.load_items([dict(it) for it in items], now)
    teng.load_items([dict(it) for it in items], now)
    assert (torch.cat(calls) % (LC + 1) != LC).all()
    monkeypatch.undo()
    assert teng.metric_unexpired_evictions > 0
    assert_same(jeng, teng)
    process(jeng, teng, *requests(rng, fresh[:20] + keys_on({0, 3}, 8, "s")),
            now + 1_000)
    assert_same(jeng, teng)


def test_items_round_trip_into_fresh_meshes():
    """A port mesh's export loaded into fresh JAX and port meshes: the
    three exports agree, less the items that expired."""
    rng = np.random.default_rng(67)
    src = MeshTickEngine(n_shards=N_SHARDS, local_capacity=LC, max_batch=MB,
                         device="cpu")
    now = NOW + 100_000
    for k in range(3):
        src.process(requests(rng, keys_on(range(N_SHARDS), 40, f"r{k}_"))[1],
                    now + k)
    items = src.export_items()
    jdst = JaxMesh(mesh=make_mesh(jax.devices()[:N_SHARDS]),
                   local_capacity=LC, max_batch=MB)
    tdst = MeshTickEngine(n_shards=N_SHARDS, local_capacity=LC, max_batch=MB,
                          device="cpu")
    later = now + 30_000
    jdst.load_items([dict(it) for it in items], later)
    tdst.load_items([dict(it) for it in items], later)
    want = [it for it in items if it["expire_at"] >= later]
    assert 0 < len(want) < len(items)
    got = tdst.export_items()
    assert got == jdst.export_items()
    assert sorted(got, key=lambda it: it["key"]) == sorted(
        want, key=lambda it: it["key"])
    assert_guard_rows_zero(tdst)


# ----------------------------------------------------------------------
# The service layer with tpu_mesh_shards=2
# ----------------------------------------------------------------------
@pytest.fixture
def clock(monkeypatch):
    """Both packages' wall clock, moved only by the test."""
    t = {"now": NOW}
    monkeypatch.setattr(jtimeutil, "now_ms", lambda: t["now"])
    monkeypatch.setattr(timeutil, "now_ms", lambda: t["now"])
    return t


MESH_CONF = dict(tpu_mesh_shards=2, tpu_platform="cpu", cache_size=1024,
                 tpu_max_batch=64)


def test_instance_installs_globals_and_uses_a_store_as_jax(clock):
    """The C.9 repro: ``update_peer_globals`` on a mesh node installs, and
    the installed keys answer the installed state; the node's Store sees
    the JAX node's call sequence."""
    rng = np.random.default_rng(68)
    keys = [f"k{i}" for i in range(12)]
    ju, tu = global_updates(rng, keys[:8], NOW)
    jreqs, treqs = requests(rng, keys)

    async def run(mod, store, updates, reqs):
        inst = await mod.V1Instance.create(mod.InstanceConfig(
            store=store, **MESH_CONF))
        assert type(inst.engine).__name__ == "MeshTickEngine"
        await inst.update_peer_globals(updates)
        clock["now"] = NOW + 1_000
        out = answers(await inst.get_rate_limits(reqs))
        await inst.close()
        clock["now"] = NOW
        return out

    js, ts = JStore(), TStore()
    want = asyncio.run(run(jinstance, js, ju, jreqs))
    got = asyncio.run(run(tinstance, ts, tu, treqs))
    assert got == want
    assert ts.log == js.log and ts.data == js.data
    assert {op for op, *_ in ts.log} >= {"get", "on_change"}


def test_instance_with_snapshot_dir_runs_without_persistence(tmp_path,
                                                           clock):
    """The mesh has no columnar snapshot: the node starts and closes
    without the snapshot writer, as the JAX node does."""
    async def run(mod, d):
        inst = await mod.V1Instance.create(mod.InstanceConfig(
            snapshot_dir=str(d), **MESH_CONF))
        assert inst._snapshot_writer is None and inst.restore_stats == {}
        await inst.close()

    for mod, sub in ((jinstance, "jax"), (tinstance, "port")):
        d = tmp_path / sub
        d.mkdir()
        asyncio.run(run(mod, d))
        assert list(d.iterdir()) == []


def test_instance_columnar_loader_restores_and_saves_items(tmp_path, clock):
    """A columnar Loader on a mesh node restores through ``load_items``
    and saves through ``export_items``, as on the JAX node."""
    rng = np.random.default_rng(69)
    src = MeshTickEngine(n_shards=2, local_capacity=512, max_batch=64,
                         device="cpu")
    src.process(requests(rng, [f"l{i}" for i in range(40)])[1], NOW)
    items = src.export_items()

    async def run(mod, path):
        loader = getattr(tstore if mod is tinstance else jstore,
                         "ColumnFileLoader")(str(path))
        loader.save(items)
        inst = await mod.V1Instance.create(mod.InstanceConfig(
            loader=loader, **MESH_CONF))
        assert inst.engine.cache_size() == len(items)
        await inst.close()
        return loader.load()

    want = asyncio.run(run(jinstance, tmp_path / "jax.npz"))
    got = asyncio.run(run(tinstance, tmp_path / "port.npz"))
    assert got == want
    assert sorted(got, key=lambda it: it["key"]) == sorted(
        items, key=lambda it: it["key"])


def test_instance_mesh_cold_cache_warns_and_ssd_dir_raises(caplog, clock):
    async def run():
        inst = await tinstance.V1Instance.create(tinstance.InstanceConfig(
            cold_cache_size=64, **MESH_CONF))
        out = await inst.get_rate_limits(requests(
            np.random.default_rng(70), ["c0", "c1"])[1])
        await inst.close()
        return out

    with caplog.at_level(logging.WARNING, logger="gubernator.instance"):
        out = asyncio.run(run())
    assert [r.error for r in out] == ["", ""]
    assert any("GUBER_COLD_CACHE_SIZE is not supported by the sharded mesh"
               in r.getMessage() for r in caplog.records)
    with pytest.raises(ValueError, match="GUBER_SSD_DIR is not supported"):
        asyncio.run(tinstance.V1Instance.create(tinstance.InstanceConfig(
            cold_cache_size=64, ssd_dir="/nonexistent", **MESH_CONF)))


def test_two_node_mesh_cluster_takes_a_global_broadcast():
    """Two daemons over 2-shard mesh engines: GLOBAL hits at the
    non-owner reach the owner, whose broadcast installs its count on the
    non-owner's mesh (``install_globals``)."""
    from tests.test_torch_cluster import bounded, call, probe, req

    async def run():
        c = Cluster()
        try:
            for _ in range(2):
                conf = _daemon_config(
                    behaviors=BehaviorConfig(batch_timeout=30,
                                             global_sync_wait=0.02),
                    cache_size=1024, tpu_platform="cpu", tpu_max_batch=64)
                conf.config.tpu_mesh_shards = 2
                d = Daemon(conf)
                await d.start()
                c.daemons.append(d)
            c.peers = [ttypes.PeerInfo(grpc_address=d.conf.grpc_listen_address,
                                       http_address="", datacenter="")
                       for d in c.daemons]
            for d in c.daemons:
                d.set_peers(c.peers)
            for d in c.daemons:
                await d.wait_for_connect()
            owner = c.find_owning_daemon("g", "mesh")
            (other,) = c.list_non_owning_daemons("g", "mesh")
            assert type(other.instance.engine).__name__ == "MeshTickEngine"
            installs = []
            orig = other.instance.engine.install_globals
            other.instance.engine.install_globals = (
                lambda ups, now=None: (installs.append(len(ups)),
                                       orig(ups, now)))
            for hits in (3, 2):
                (r,) = await call(other, [req(name="g", key="mesh",
                                              hits=hits, limit=10,
                                              behavior=GLOBAL)])
                assert r.error == ""
                await wait_quiet(c.daemons, 30)
            await bounded(c.wait_for_broadcast(
                c.daemons.index(owner), 1, timeout=30))
            await wait_quiet(c.daemons, 30)
            assert installs
            for d in c.daemons:
                (r,) = await call(d, [probe("mesh")])
                assert r.remaining == 5, d is owner
        finally:
            await c.stop()

    asyncio.run(run())
