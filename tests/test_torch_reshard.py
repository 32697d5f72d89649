"""Live resharding in the port against the JAX package, on the CPU.

* ``LayoutTransition`` / ``plan_transition`` / ``relayout_host`` against
  the JAX ``partition`` module over a grid of shapes, errors included.
* The port's ``MeshTickEngine.reshard`` against the JAX mesh's on the
  4-device CPU mesh (local capacity 32, 128 lanes a window): 4 -> 2 -> 4
  over live, expired and repeated state; every key's global slot, every
  exported item, and the answers of a duplicate window whose hot run
  crosses the walk's chunk boundary after each cutover.  This is the
  module's one JAX mesh (its reshards compile the new layouts).
* The columns route of ``reshard`` against the items route (export_items,
  a new layout, load_items) on the port's CPU mesh, 8 -> 3 overflowing a
  shard, with a key resident on two shards; the rollback of a failure
  inside the cutover.
* ``ReshardCoordinator``, ``TickLoop.freeze`` / ``quiesce`` and the shed
  answers against the JAX classes over the same stub engines (no JAX
  compile), and the census verify against the ``export_items`` one.
* ``V1Instance.reshard``, ``POST /debug/reshard`` and ``/debug/state`` on
  port nodes, against a JAX node where both run the identity transition,
  and crash detection from a journal with a ``begin`` record.
"""

import asyncio
import json
import threading
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

import jax

from gubernator_tpu.admission import (
    CLASS_PEER as J_CLASS_PEER, AdmissionConfig as JAdmissionConfig)
from gubernator_tpu.parallel import partition as jpartition
from gubernator_tpu.parallel import reshard as jreshard
from gubernator_tpu.parallel.mesh_engine import (
    MeshTickEngine as JaxMesh, make_mesh)
from gubernator_tpu.persistence import TransitionLog as JTransitionLog
from gubernator_tpu.service.tickloop import TickLoop as JTickLoop
from gubernator_tpu.types import (
    RateLimitRequest as JRequest, RateLimitResponse as JResponse)
from gubernator_tpu.utils.metrics import Metrics as JMetrics
from gubernator_tpu_torch import config
from gubernator_tpu_torch.admission import CLASS_PEER, AdmissionConfig
from gubernator_tpu_torch.ops.raggedtick import choose_tile
from gubernator_tpu_torch.parallel import mesh_engine, partition, reshard
from gubernator_tpu_torch.parallel.mesh_engine import MeshTickEngine
from gubernator_tpu_torch.persistence import (
    TransitionLog, TransitionRecord, check_interrupted)
from gubernator_tpu_torch.service import instance
from gubernator_tpu_torch.service.tickloop import TickLoop
from gubernator_tpu_torch.transport import daemon
from gubernator_tpu_torch.types import RateLimitRequest, RateLimitResponse
from gubernator_tpu_torch.utils.metrics import Metrics
from tests.test_torch_common import NOW, req_columns

LC, MB = 32, 128


# ----------------------------------------------------------------------
# The transition spec
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", (1, 3, 4, 8))
@pytest.mark.parametrize("c", (1, 7, 128))
def test_plan_transition_matches_jax(n, c):
    """Every target of 1-8 shards, with the full and carried live counts."""
    g = np.arange(n * c)
    for m in (1, 2, 3, 5, 8):
        for live in (None, 1, max(1, n * c // 2)):
            t = partition.plan_transition(n, c, m, live_slots=live)
            j = jpartition.plan_transition(n, c, m, live_slots=live)
            assert (t.n_from, t.cap_from, t.n_to, t.cap_to,
                    t.live_slots) == (j.n_from, j.cap_from, j.n_to,
                                      j.cap_to, j.live_slots)
            assert (t.capacity_to, t.capacity_from) == (j.capacity_to,
                                                        j.capacity_from)
            np.testing.assert_array_equal(t.remap(), j.remap())
            for f in ("owner_of", "local_of", "old_owner_of"):
                np.testing.assert_array_equal(getattr(t, f)(g),
                                              getattr(j, f)(g))
            back, jback = t.then(n), j.then(n)
            assert (back.cap_to, back.live_slots) == (jback.cap_to,
                                                      jback.live_slots)
            if live is None:
                assert back.cap_to == c   # n -> m -> n is a round trip


@pytest.mark.parametrize("args", [(0, 4, 2), (4, 0, 2), (4, 4, 0),
                                  (4, 4, 2, 0), (4, 4, 2, 17)])
def test_plan_transition_errors_match_jax(args):
    live = args[3] if len(args) > 3 else None
    with pytest.raises(ValueError) as want:
        jpartition.plan_transition(*args[:3], live_slots=live)
    with pytest.raises(ValueError) as got:
        partition.plan_transition(*args[:3], live_slots=live)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,c,m", [(8, 16, 3), (3, 43, 8), (4, 8, 4)])
def test_relayout_host_matches_jax_block(n, c, m):
    """Each old shard's rows land where the JAX relayout block puts them;
    the shards' buffers are disjoint, so their sum is their union."""
    import jax.numpy as jnp

    tr = partition.plan_transition(n, c, m)
    jtr = jpartition.plan_transition(n, c, m)
    x = np.arange(n * c * 2, dtype=np.int64).reshape(n * c, 2) + 1
    total = np.zeros((tr.capacity_to, 2), np.int64)
    for s in range(n):
        blk = x[s * c:(s + 1) * c]
        got = partition.relayout_host(blk, s, tr)
        want = np.asarray(jpartition.relayout_block(
            jnp.asarray(blk), jnp.int32(s), jtr))
        np.testing.assert_array_equal(got, want)
        total += got
    np.testing.assert_array_equal(total[:n * c], x)   # the flat identity


# ----------------------------------------------------------------------
# The engine's reshard against the JAX mesh's
# ----------------------------------------------------------------------
def keys_on(n_shards, shards, count, prefix):
    out, i = [], 0
    while len(out) < count:
        k = f"{prefix}{i}".encode()
        if zlib.crc32(b"rs_" + k) % n_shards in shards:
            out.append(k)
        i += 1
    return out


def slots_of(eng, keys):
    """Each key's global slot on either package's mesh."""
    out = []
    for k in keys:
        d = zlib.crc32(k.encode()) % eng.n_shards
        sm = eng.slots[d]
        local = (sm.get(k) if hasattr(sm, "get") else
                 int(sm.lookup_blob(k.encode(), np.array([0, len(k)]))[0]))
        out.append(d * eng.local_capacity + local)
    return out


def assert_meshes_equal(jeng, teng):
    assert (teng.n_shards, teng.local_capacity) == (jeng.n_shards,
                                                    jeng.local_capacity)
    items = teng.export_items()
    assert items == jeng.export_items()
    keys = [it["key"] for it in items]
    assert slots_of(teng, keys) == slots_of(jeng, keys)
    assert teng.cache_size() == jeng.cache_size()


def mesh_window(rng, keys, now, herd=False):
    """Matching JAX and port windows over ``keys`` (bytes); with ``herd``
    every request of a key repeats its first one."""
    jc, tc = req_columns(rng, len(keys), [b"rs_" + k for k in keys])
    created = np.where(rng.random(len(keys)) < 0.5, -1, now)
    for c in (jc, tc):
        c.created_at[:] = created
    if herd:
        first = {}
        for j, k in enumerate(keys):
            first.setdefault(k, j)
        src = np.array([first[k] for k in keys])
        for c in (jc, tc):
            for f in ("hits", "limit", "duration", "algorithm", "behavior",
                      "created_at", "burst"):
                getattr(c, f)[:] = getattr(c, f)[src]
    return jc, tc


def feed(jeng, teng, wins):
    for jc, tc, now in wins:
        want, werr = jeng.process_columns(jc, now)
        got, gerr = teng.process_columns(tc, now)
        assert gerr == werr
        np.testing.assert_array_equal(got, want)


def crossing_window(rng, n_shards, now, prefix):
    """A window of MB lanes, most of them one hot key's (its run spans the
    walk's chunk boundary: the extent is longer than the chunk), the rest
    random keys; herd requests."""
    hot = keys_on(n_shards, {1}, 1, prefix + "h")[0]
    rest = keys_on(n_shards, range(n_shards), 40, prefix + "r")
    ids = [hot] * 90 + [rest[i] for i in rng.integers(0, 40, MB - 90)]
    rng.shuffle(ids)
    assert 90 > choose_tile(MB, n_shards)
    return (*mesh_window(rng, ids, now, herd=True), now)


def test_reshard_matches_the_jax_mesh():
    jeng = JaxMesh(mesh=make_mesh(jax.devices()[:4]), local_capacity=LC,
                   max_batch=MB)
    teng = MeshTickEngine(n_shards=4, local_capacity=LC, max_batch=MB,
                          device="cpu")
    rng = np.random.default_rng(71)
    pool = keys_on(4, range(4), 100, "k")
    now = NOW
    wins = []
    for k in range(5):
        now += 1_500
        ids = [pool[i] for i in rng.integers(0, 100, 90 if k % 2 else 60)]
        wins.append((*mesh_window(rng, ids, now, herd=k == 3), now))
    feed(jeng, teng, wins)
    assert_meshes_equal(jeng, teng)
    live0 = len(teng.export_items())
    # Some rows expire by the cutover's now: both packages drop them.
    cut = now + 40_000
    for n_to, tag in ((2, "a"), (4, "b")):
        want = jeng.reshard(n_to, now=cut)
        got = teng.reshard(n_to, now=cut)
        assert got == want
        assert_meshes_equal(jeng, teng)
        cut += 1_000
        feed(jeng, teng, [crossing_window(rng, n_to, cut, tag),
                          (*mesh_window(rng, [pool[i] for i in rng.integers(
                              0, 100, 70)], cut + 5), cut + 5)])
        assert_meshes_equal(jeng, teng)
        cut += 1_000
    assert 0 < len(teng.export_items())
    assert live0 > 0
    assert teng.reshard(4) == jeng.reshard(4)   # a no-op


# ----------------------------------------------------------------------
# The columns route against the items route, and the rollback
# ----------------------------------------------------------------------
def items_route(eng, n_to, now):
    """The reference's transition over the port's own engine: the live
    items exported, a new layout built, the items loaded into it."""
    items = eng.export_items()
    tr = partition.plan_transition(eng.n_shards, eng.local_capacity, n_to)
    new = eng._build_shard_set(tr)
    eng.n_shards, eng.local_capacity = new.n_shards, new.local_capacity
    eng.capacity, eng.ragged, eng.table = new.capacity, new.ragged, new.table
    eng.slots, eng._last_access = new.slots, new.last_access
    eng._staging, eng._pending, eng._inflight = new.staging, set(), 0
    eng.load_items(items, now)
    return len(items)


def engine_fields(eng):
    keys = [sm.keys_batch(np.arange(eng.local_capacity)) for sm in eng.slots]
    return (eng.n_shards, eng.local_capacity, keys, eng.table.clone(),
            eng._last_access.copy(), eng._tick_count, sorted(eng._pending),
            eng.metric_unexpired_evictions)


def filled_pair(n, lc, keys, seed):
    """Two port meshes fed the same windows over ``keys`` (str), some with
    short durations so that their rows expire."""
    engs = [MeshTickEngine(n_shards=n, local_capacity=lc, max_batch=64,
                           device="cpu") for _ in range(2)]
    rng = np.random.default_rng(seed)
    now = NOW
    for a in range(0, len(keys), 64):
        part = [k.encode() for k in keys[a:a + 64]]
        _, tc = mesh_window(rng, part, now)
        tc.duration[rng.random(len(part)) < 0.2] = 500
        for e in engs:
            e.process_columns(tc, now)
        now += 10
    return engs, now


@pytest.mark.parametrize("n_from,n_to", [(8, 3), (4, 2), (2, 5)])
def test_columns_route_matches_items_route(n_from, n_to):
    keys = [f"c{i}" for i in range(8 * 15)]
    (a, b), now = filled_pair(n_from, 128 // n_from, keys, n_from * 10 + n_to)
    # A damaged table: one key also resident on a second shard (the last
    # copy in slot order wins, in the first copy's place).
    k = keys[3].encode()
    home = zlib.crc32(b"rs_" + k) % n_from
    other = (home + 1) % n_from
    for e in (a, b):
        s = int(e.slots[other].assign_blob(b"rs_" + k,
                                           np.array([0, len(k) + 3]))[0])
        g = other * e.local_capacity + s
        e.table[g + g // e.local_capacity] = e.table[0].clone()
        e.table[g + g // e.local_capacity, 10] = 1
        e.table[g + g // e.local_capacity, 9] = now + 10**6
    cut = now + 2_000
    info = a.reshard(n_to, now=cut)
    live = items_route(b, n_to, cut)
    assert info["live_items"] == live
    fa, fb = engine_fields(a), engine_fields(b)
    for x, y in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y
    assert a.export_items() == b.export_items()
    if (n_from, n_to) == (8, 3):   # a shard overflowed: keys dropped
        assert len(a.export_items()) < live - 1


def test_failed_cutover_restores_the_old_layout(monkeypatch):
    (eng, twin), now = filled_pair(4, 32, [f"f{i}" for i in range(100)], 3)
    before = engine_fields(eng)
    table = eng.table

    def boom(*a, **k):
        raise RuntimeError("injected scatter failure")

    monkeypatch.setattr(mesh_engine, "scatter_chunked", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.reshard(2, now=now)
    monkeypatch.undo()
    after = engine_fields(eng)
    assert eng.table is table
    assert before[:2] == after[:2] and before[2] == after[2]
    assert torch.equal(before[3], after[3])
    np.testing.assert_array_equal(before[4], after[4])
    assert eng.capacity == 4 * 32 and eng.ragged.n_shards == 4
    # It serves on as before.
    rng = np.random.default_rng(9)
    _, tc = mesh_window(rng, [f"f{i}".encode() for i in range(40)], now + 5)
    twin._tick_count = eng._tick_count
    np.testing.assert_array_equal(eng.process_columns(tc, now + 5)[0],
                                  twin.process_columns(tc, now + 5)[0])
    with pytest.raises(ValueError, match="several cards"):
        eng.reshard(2, devices=["meta"])
    with pytest.raises(ValueError, match=">= 1"):
        eng.reshard(0)


# ----------------------------------------------------------------------
# The coordinator, the freeze and the shed answers against the JAX classes
# ----------------------------------------------------------------------
class _Batch:
    def __init__(self, reqs, resp_type):
        self._reqs, self._resp = reqs, resp_type

    def handles(self):
        return []

    def responses(self):
        return [self._resp(status=0, limit=r.limit,
                           remaining=r.limit - r.hits) for r in self._reqs]


class _StubEngine:
    """The JAX reshard tests' stub: records batches, carries a key census
    for the degenerate path and the verify phase."""

    def __init__(self, resp_type, items=(), export=None, live=None,
                 fail=False, shards=None, parity=None):
        self.resp_type = resp_type
        self.batches = []
        self.items = list(items)
        self._export, self._live, self._fail = export, live, fail
        if shards is not None:
            self.n_shards = shards
        if live is not None or fail:
            self.reshard = self._reshard
        if parity is not None:
            self.routing_parity_errors = lambda keys: parity

    def submit(self, reqs):
        self.batches.append(list(reqs))
        return _Batch(reqs, self.resp_type)

    def cache_size(self):
        return len(self.items)

    def export_items(self):
        return [dict(it) for it in (self._export or self.items)]

    def _reshard(self, new_shards):
        if self._fail:
            raise RuntimeError("device lost")
        return {"live_items": self._live}


class _StubLoop:
    def __init__(self, quiesce_ok=True):
        self.calls = []
        self.quiesce_ok = quiesce_ok

    def freeze(self, shed_peers=False):
        self.calls.append(("freeze", shed_peers))

    def unfreeze(self):
        self.calls.append(("unfreeze",))

    def quiesce(self, timeout):
        self.calls.append(("quiesce", timeout))
        return self.quiesce_ok


class _Pausable:
    def __init__(self):
        self.log = []

    def pause_reconcile(self):
        self.log.append("pause")

    def resume_reconcile(self):
        self.log.append("resume")


def _items(n):
    return [{"key": f"it-{i}", "remaining": 5, "expire_at": 1 << 60}
            for i in range(n)]


SCENARIOS = {
    "commit": dict(items=_items(7)),
    "drain_timeout": dict(items=_items(3), quiesce_ok=False),
    "breaker": dict(items=_items(2), breaker=True),
    "engine_failure": dict(items=_items(2), fail=True, shards=4),
    "damaged": dict(export=[{"key": "a"}, {"key": "a"}, {"key": "b"}],
                    live=4, shards=2, parity=1),
    "mesh": dict(items=_items(5), live=5, shards=4, parity=0),
}


def run_coordinator(pkg, scenario, tmp_path):
    mod, log_cls, metrics_cls, resp = (
        (jreshard, JTransitionLog, JMetrics, JResponse) if pkg == "jax"
        else (reshard, TransitionLog, Metrics, RateLimitResponse))
    sc = dict(SCENARIOS[scenario])
    loop = _StubLoop(quiesce_ok=sc.pop("quiesce_ok", True))
    breaker = sc.pop("breaker", False)
    eng = _StubEngine(resp, **sc)
    m, gm = metrics_cls(), _Pausable()
    path = tmp_path / pkg
    coord = mod.ReshardCoordinator(
        eng, tick_loop=loop, transition_log=log_cls(str(path)),
        breaker_check=lambda: breaker, global_engine=gm, metrics=m,
        freeze_timeout=0.5)
    out = coord.try_reshard(1 if scenario == "damaged" else 2)
    out.pop("duration_s", None)
    recs = [(r.phase, r.from_shards, r.to_shards, r.epoch)
            for r in log_cls(str(path)).records()]
    samples = {}
    for name, labels in (
            ("gubernator_tpu_reshard_transitions_total",
             {"result": out.get("outcome", "")}),
            ("gubernator_tpu_reshard_phase", None),
            ("gubernator_tpu_reshard_shards", None),
            ("gubernator_tpu_reshard_state_loss_total", None),
            ("gubernator_tpu_reshard_double_served_total", None),
            ("gubernator_tpu_reshard_duration_count",
             {"result": out.get("outcome", "")})):
        samples[name] = m.sample(name, labels)
    status = coord.status()
    status["last"].pop("duration_s", None)
    return out, recs, samples, loop.calls, gm.log, status, coord.phase


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_coordinator_matches_jax(scenario, tmp_path):
    got = run_coordinator("port", scenario, tmp_path)
    want = run_coordinator("jax", scenario, tmp_path)
    assert got == want


def test_busy_and_bad_target_match_jax():
    for mod, resp in ((jreshard, JResponse), (reshard, RateLimitResponse)):
        coord = mod.ReshardCoordinator(_StubEngine(resp, items=_items(1)))
        assert coord._lock.acquire(blocking=False)
        try:
            assert coord.is_busy()
            out = coord.try_reshard(2)
            assert out == jreshard.BUSY_RESULT and out is not mod.BUSY_RESULT
            with pytest.raises(mod.ReshardError, match="already running"):
                coord.reshard(2)
        finally:
            coord._lock.release()
        with pytest.raises(mod.ReshardError, match=">= 1"):
            coord.try_reshard(0)
    assert reshard.BUSY_RESULT == jreshard.BUSY_RESULT
    assert reshard._PHASE_IDS == jreshard._PHASE_IDS


def test_census_verify_matches_the_export_verify():
    """On a damaged port mesh (a key resident on two shards, a key on the
    wrong shard, fewer live rows than expected) the census counts equal
    those of the JAX coordinator's export_items route."""
    (eng, _), now = filled_pair(4, 32, [f"v{i}" for i in range(90)], 5)
    for k, d in ((b"rs_v5", 1), (b"rs_v6", 2), (b"rs_v6", 3)):
        s = int(eng.slots[d].assign_blob(k, np.array([0, len(k)]))[0])
        g = d * 32 + s
        eng.table[g + g // 32, 10] = 1
    home = zlib.crc32(b"rs_v7") % 4
    s = int(eng.slots[home].lookup_blob(b"rs_v7", np.array([0, 5]))[0])
    eng.slots[home].release_batch(np.array([s]))   # v7 lost its home
    s2 = int(eng.slots[(home + 1) % 4].assign_blob(
        b"rs_v7", np.array([0, 5]))[0])
    g = (home + 1) % 4 * 32 + s2
    eng.table[g + g // 32, 10] = 1
    live = len(eng.export_items()) + 3

    class _Exporter:   # the same table seen through export_items only
        export_items = eng.export_items
        routing_parity_errors = eng.routing_parity_errors

    want = jreshard.ReshardCoordinator(_Exporter())._verify(live)
    got = reshard.census_counts(eng.census(), live)
    assert got == want
    assert got[1] > 0 and got[2] > 0


def _reqs(types, n):
    return [types(name="rs", unique_key=str(i), hits=1, limit=100,
                  duration=60_000, created_at=1_000) for i in range(n)]


def freeze_answers(pkg):
    loop_cls, adm, req, resp, peer, metrics = (
        (JTickLoop, JAdmissionConfig, JRequest, JResponse, J_CLASS_PEER,
         JMetrics) if pkg == "jax" else
        (TickLoop, AdmissionConfig, RateLimitRequest, RateLimitResponse,
         CLASS_PEER, Metrics))
    eng = _StubEngine(resp)
    m = metrics()
    loop = loop_cls(eng, admission=adm(), metrics=m)
    out = []
    try:
        loop.freeze()
        out.append([r.error for r in loop.submit(_reqs(req, 2)).result(5)])
        out.append([(r.error, r.remaining) for r in loop.submit(
            _reqs(req, 1), klass=peer).result(5)])
        out.append(loop.frozen)
        loop.freeze(shed_peers=True)
        loop.freeze()   # never downgrades
        out.append([r.error for r in loop.submit(
            _reqs(req, 1), klass=peer).result(5)])
        loop.unfreeze()
        out.append([r.error for r in loop.submit(_reqs(req, 3)).result(5)])
        out.append(loop.quiesce(timeout=5.0))
        out.append(sum(len(b) for b in eng.batches))
        out.append(m.sample("gubernator_tpu_admission_shed_total",
                            {"reason": "reshard"}))
        out.append(dict(loop.metric_shed_admission))
    finally:
        loop.close()
    return out


def test_freeze_and_shed_answers_match_jax():
    got, want = freeze_answers("port"), freeze_answers("jax")
    assert got == want
    assert got[0] == [reshard_msg()] * 2


def reshard_msg():
    from gubernator_tpu.admission import SHED_RESHARD_MSG

    return SHED_RESHARD_MSG


def test_quiesce_waits_for_a_window_inside_dispatch():
    gate = threading.Event()

    class _Gated(_StubEngine):
        def submit(self, reqs):
            gate.wait(timeout=10)
            return super().submit(reqs)

    loop = TickLoop(_Gated(RateLimitResponse), admission=AdmissionConfig())
    try:
        fut = loop.submit(_reqs(RateLimitRequest, 1))
        assert not loop.quiesce(timeout=0.2)
        gate.set()
        assert fut.result(timeout=5)[0].error == ""
        assert loop.quiesce(timeout=5.0)
    finally:
        gate.set()
        loop.close()


# ----------------------------------------------------------------------
# The instance and the daemon
# ----------------------------------------------------------------------
def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _strip(doc):
    doc = dict(doc)
    doc.pop("duration_s", None)
    return doc


async def debug_answers(d, shards):
    """The /debug/reshard answers of daemon ``d`` (200, 400 twice, 409)
    and its /debug/state reshard section."""
    url = f"http://{d.conf.http_listen_address}"
    out = []
    st, doc = await asyncio.to_thread(
        _post, url + "/debug/reshard", json.dumps({"shards": shards}).encode())
    out.append((st, _strip(doc)))
    for body in (b"{}", json.dumps({"shards": 0}).encode()):
        out.append(await asyncio.to_thread(_post, url + "/debug/reshard",
                                           body))
    coord = d.instance.reshard_coord
    assert coord._lock.acquire(blocking=False)
    try:
        out.append(await asyncio.to_thread(
            _post, url + "/debug/reshard", b'{"shards": 3}'))
    finally:
        coord._lock.release()
    state = (await asyncio.to_thread(_get, url + "/debug/state"))["reshard"]
    state["last"] = _strip(state["last"])
    out.append(state)
    return out


async def test_debug_reshard_answers_as_the_jax_daemon(monkeypatch):
    """Both daemons over a single-card engine run the identity transition:
    the same 200, 400 and 409 answers and the same /debug/state section."""
    from gubernator_tpu import config as jconfig
    from gubernator_tpu.ops.engine import TickEngine as JaxEngine
    from gubernator_tpu.transport import daemon as jdaemon

    monkeypatch.setenv("GUBER_DEBUG_ENDPOINTS", "1")
    jd = await jdaemon.spawn_daemon(jconfig.DaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
        config=jconfig.Config(cache_size=1024, tpu_max_batch=64)),
        engine=JaxEngine(capacity=1024, max_batch=64))
    td = await daemon.spawn_daemon(config.DaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
        config=config.Config(cache_size=1024, tpu_max_batch=64,
                             tpu_platform="cpu")))
    try:
        want = await debug_answers(jd, 2)
        got = await debug_answers(td, 2)
        assert got == want
        assert got[0][0] == 200 and got[0][1]["degenerate"] is True
        assert [a[0] for a in got[1:4]] == [400, 400, 409]
    finally:
        await td.close()
        await jd.close()


async def test_mesh_node_reshards_live(monkeypatch):
    """A port node over a 4-shard mesh: POST /debug/reshard {"shards": 2}
    commits a real transition with zero verify counts; the node answers
    its keys as before the cutover."""
    monkeypatch.setenv("GUBER_DEBUG_ENDPOINTS", "1")
    td = await daemon.spawn_daemon(config.DaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
        config=config.Config(cache_size=256, tpu_max_batch=64,
                             tpu_mesh_shards=4, tpu_platform="cpu")))
    try:
        inst = td.instance
        reqs = [RateLimitRequest(name="m", unique_key=f"u{i}", hits=1,
                                 limit=10, duration=3_600_000)
                for i in range(40)]
        first = await inst.get_rate_limits(reqs)
        ans = await debug_answers(td, 2)
        st, doc = ans[0]
        assert st == 200 and doc["outcome"] == "committed"
        assert (doc["from_shards"], doc["to_shards"]) == (4, 2)
        assert doc["live_items"] == 40
        assert (doc["state_loss"], doc["double_served"],
                doc["parity_errors"]) == (0, 0, 0)
        assert [a[0] for a in ans[1:4]] == [400, 400, 409]
        assert ans[4]["shards"] == 2 and ans[4]["phase"] == "committed"
        again = await inst.get_rate_limits(reqs)
        assert [r.remaining for r in again] == [
            r.remaining - 1 for r in first]
        assert inst.engine.n_shards == 2
        back = await inst.reshard(4)
        assert back["outcome"] == "committed" and back["live_items"] == 40
    finally:
        await td.close()


async def test_crash_mid_cutover_is_detected(tmp_path):
    log = TransitionLog(str(tmp_path))
    log.append(TransitionRecord("begin", 4, 2, epoch=1))
    m = Metrics()
    inst = await instance.V1Instance.create(instance.InstanceConfig(
        cache_size=64, tpu_max_batch=16, tpu_mesh_shards=4,
        tpu_platform="cpu", snapshot_dir=str(tmp_path), metrics=m))
    try:
        assert m.sample("gubernator_tpu_reshard_transitions_total",
                        {"result": "interrupted"}) == 1
        assert check_interrupted(TransitionLog(str(tmp_path))) is None
        assert inst.reshard_status()["phase"] == "idle"
    finally:
        await inst.close()


def test_reshard_knobs_are_read():
    conf = config.setup_daemon_config(environ={
        "GUBER_RESHARD_FREEZE_TIMEOUT": "2.5s",
        "GUBER_RESHARD_VERIFY": "false"})
    c = conf.config
    assert (c.reshard_freeze_timeout, c.reshard_verify) == (2.5, False)
    ic = instance.InstanceConfig.from_config(c)
    assert (ic.reshard_freeze_timeout, ic.reshard_verify) == (2.5, False)
    with pytest.raises(ValueError, match="FREEZE_TIMEOUT"):
        config.setup_daemon_config(
            environ={"GUBER_RESHARD_FREEZE_TIMEOUT": "0s"})
