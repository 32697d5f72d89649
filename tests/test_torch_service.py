"""The serving slice against the JAX package: V1Instance and the daemon.

A JAX ``V1Instance`` over ``TickEngine(capacity=1024, max_batch=64)`` (a
shape the JAX tests already compile) and a port ``V1Instance``
(``tpu_platform="cpu"``) start from the same state (the JAX engine's
``export_columns`` loaded into the port's) and get the same serial calls,
each awaited before the next so the windows are the same: the object
path with GLOBAL, RESET and invalid items, and the columns path.  Both
packages' clocks are pinned (``timeutil.now_ms``), every algorithm runs,
and leaky (duration, limit) pairs are exact quotients (ROADMAP C.1).
Responses, (5, n) matrices, the exported state and the ``/metrics`` text
must be equal.  Both nodes re-read every GLOBAL key in the background
(their GLOBAL manager's broadcast, ROADMAP C.8), so GLOBAL items keep
their negative hits and the exports are compared once the re-reads
landed.  A JAX daemon and a port daemon then answer the same raw
``GetRateLimitsReq`` bytes over gRPC with the same bytes, and the HTTP
gateway with the same JSON.
"""

import asyncio
import json
import re
import urllib.request

import numpy as np
import pytest

from gubernator_tpu import config as jconfig
from gubernator_tpu.ops.engine import TickEngine as JaxEngine
from gubernator_tpu.ops.reqcols import ReqColumns as JReqColumns
from gubernator_tpu.pb import gubernator_pb2 as pb
from gubernator_tpu.service import instance as jinstance
from gubernator_tpu.transport import daemon as jdaemon
from gubernator_tpu.types import RateLimitRequest as JRequest
from gubernator_tpu.utils import timeutil as jtimeutil
from gubernator_tpu_torch import config
from gubernator_tpu_torch.ops.reqcols import ReqColumns
from gubernator_tpu_torch.service import instance
from gubernator_tpu_torch.transport import daemon
from gubernator_tpu_torch.types import RateLimitRequest
from gubernator_tpu_torch.utils import timeutil
from tests.test_torch_common import EXACT_DL, NOW

CAP, WIDTH = 1024, 64
GLOBAL, RESET, DRAIN, MULTI_REGION = 2, 8, 32, 16


@pytest.fixture
def clock(monkeypatch):
    """Both packages' wall clock, moved only by the test."""
    t = {"now": NOW}
    monkeypatch.setattr(jtimeutil, "now_ms", lambda: t["now"])
    monkeypatch.setattr(timeutil, "now_ms", lambda: t["now"])
    return t


def items(rng, n, k, *, objects=True):
    """``n`` request field dicts of call ``k``: every algorithm, RESET and
    DRAIN rows, explicit or server-stamped created_at; on the object
    path also GLOBAL items and invalid ones.  Both nodes re-read each
    GLOBAL key in the background (a hits-0 copy of the item, the GLOBAL
    manager's broadcast), which clamps a leaky bucket that negative hits
    took over its limit (ROADMAP C.8); GLOBAL items get keys of their
    own and keep their negative hits."""
    out = []
    for i in range(n):
        d, lim = EXACT_DL[int(rng.integers(0, len(EXACT_DL)))]
        f = dict(name=f"svc{int(rng.integers(0, 3))}",
                 unique_key=f"k{int(rng.integers(0, 40))}",
                 hits=int(rng.choice([0, 1, 1, 2, 5, -1])), limit=lim,
                 duration=d, algorithm=int(rng.integers(0, 5)),
                 behavior=int(rng.choice([0, 0, 0, RESET, DRAIN])),
                 burst=int(rng.choice([0, 0, 20])),
                 created_at=(None if rng.random() < 0.5
                             else NOW + 1000 * k - int(rng.integers(0, 3000))))
        pick = rng.random()
        if objects and pick < 0.12:
            f.update(unique_key=f"g{k}_{i}", behavior=GLOBAL,
                     duration=int(rng.choice([60_000, 3_600_000])),
                     limit=1000, algorithm=int(rng.integers(0, 2)))
        elif objects and pick < 0.2:
            f.update(rng.choice([{"name": ""}, {"unique_key": ""},
                                 {"algorithm": 7},
                                 {"behavior": MULTI_REGION}]))
        out.append(f)
    return out


def columns(pkg_cols, fields):
    cols = pkg_cols.from_requests([RateLimitRequest(**f) for f in fields])
    return pkg_cols(**{**vars(cols), "refs": None})


def jcolumns(fields):
    return JReqColumns.from_requests([JRequest(**f) for f in fields])


async def started(seed_state=True):
    jeng = JaxEngine(capacity=CAP, max_batch=WIDTH)
    if seed_state:
        rng = np.random.default_rng(1)
        jeng.process([JRequest(**f) for f in items(rng, 60, -5,
                                                   objects=False)],
                     now=NOW - 5_000)
    j = await jinstance.V1Instance.create(
        jinstance.InstanceConfig(cache_size=CAP, tpu_max_batch=WIDTH),
        engine=jeng)
    t = await instance.V1Instance.create(instance.InstanceConfig(
        cache_size=CAP, tpu_max_batch=WIDTH, tpu_platform="cpu"))
    t.engine.load_columns(jeng.export_columns(), now=NOW - 5_000)
    return j, t


def by_key(snap):
    """An export's rows by key (slot order differs between engines that
    were filled in different orders)."""
    off = snap["key_offsets"]
    keys = [bytes(snap["key_blob"][off[i]:off[i + 1]])
            for i in range(len(off) - 1)]
    fields = [f for f in snap if f not in ("key_blob", "key_offsets")]
    return {k: tuple(np.asarray(snap[f])[i].item() for f in fields)
            for i, k in enumerate(keys)}


async def settled(*insts, before):
    """Wait (bounded) until each instance's GLOBAL manager has broadcast
    once more than ``before`` (its count when the call was sent): the
    call's GLOBAL items were all queued in one window, so that broadcast
    re-read them all."""
    for inst, n in zip(insts, before):
        async def landed(inst=inst, n=n):
            while inst.metrics.sample(
                    "gubernator_broadcast_duration_count") < n + 1:
                await asyncio.sleep(0.005)
        await asyncio.wait_for(landed(), 30)


def broadcasts(*insts):
    return [i.metrics.sample("gubernator_broadcast_duration_count")
            for i in insts]


def has_global_hits(fields):
    return any(f["behavior"] == GLOBAL and f["hits"] != 0
               and f["name"] and f["unique_key"] for f in fields)


def assert_same_export(j, t, keys=None):
    """Equal exports, or with ``keys`` equal rows of those keys (a load
    drops rows already expired, which the engine it came from keeps)."""
    a, b = j.engine.export_columns(), t.engine.export_columns()
    assert sorted(a) == sorted(b)
    a, b = by_key(a), by_key(b)
    if keys is not None:
        a = {k: a.get(k) for k in keys}
        b = {k: b.get(k) for k in keys}
    assert a == b


async def drive(j, t, clock, seed, calls=16):
    rng = np.random.default_rng(seed)
    for k in range(calls):
        clock["now"] = NOW + 1000 * k
        fields = items(rng, int(rng.integers(1, 100)), k,
                       objects=k % 2 == 1)
        if k % 2:
            before = broadcasts(j, t)
            want = await j.get_rate_limits([JRequest(**f) for f in fields])
            got = await t.get_rate_limits(
                [RateLimitRequest(**f) for f in fields])
            assert [vars(r) for r in got] == [vars(r) for r in want], k
            if has_global_hits(fields):
                # The GLOBAL items' background re-reads, then their rows.
                await settled(j, t, before=before)
                assert_same_export(j, t, keys={
                    f"{f['name']}_{f['unique_key']}".encode()
                    for f in fields if f["behavior"] == GLOBAL})
        else:
            wm, we = await j.get_rate_limits_columns(jcolumns(fields))
            gm, ge = await t.get_rate_limits_columns(
                columns(ReqColumns, fields))
            assert ge == we, k
            np.testing.assert_array_equal(gm, wm, err_msg=f"call {k}")


@pytest.mark.parametrize("seed", [11, 12])
async def test_instance_answers_as_the_jax_instance(clock, seed):
    j, t = await started()
    try:
        await drive(j, t, clock, seed)
        # Relayed batches: forwarded GLOBAL hits drain over the limit.
        rng = np.random.default_rng(seed + 100)
        fields = items(rng, 40, 99)
        want = await j.get_peer_rate_limits([JRequest(**f) for f in fields])
        got = await t.get_peer_rate_limits(
            [RateLimitRequest(**f) for f in fields])
        assert [vars(r) for r in got] == [vars(r) for r in want]
        assert vars(t.health_check()) == vars(j.health_check())
        assert t.occupancy() == j.occupancy()
    finally:
        await j.close()
        await t.close()
    assert_same_export(j, t)


async def test_batch_limits_and_peers_match(clock):
    j, t = await started(seed_state=False)
    try:
        big = [dict(name="a", unique_key=f"k{i}", hits=1, limit=5,
                    duration=60_000) for i in range(1001)]
        with pytest.raises(jinstance.BatchTooLargeError) as je:
            await j.get_rate_limits([JRequest(**f) for f in big])
        with pytest.raises(instance.BatchTooLargeError) as te:
            await t.get_rate_limits([RateLimitRequest(**f) for f in big])
        assert str(te.value) == str(je.value)
        with pytest.raises(instance.BatchTooLargeError):
            await t.get_rate_limits_columns(columns(ReqColumns, big))
        assert t.columns_fast_path_ok() and j.columns_fast_path_ok()
        from gubernator_tpu.types import PeerInfo as JPeerInfo
        from gubernator_tpu_torch.types import PeerInfo

        t.set_peers([PeerInfo(grpc_address="")])  # discovery "none"
        assert t.health_check().peer_count == 1
        assert t.columns_fast_path_ok()
        # Another node: the public columns path closes, the peer one stays.
        addrs = ["", "10.0.0.1:81"]
        j.set_peers([JPeerInfo(grpc_address=a) for a in addrs])
        t.set_peers([PeerInfo(grpc_address=a) for a in addrs])
        assert not t.columns_fast_path_ok() and not j.columns_fast_path_ok()
        assert t.peer_columns_fast_path_ok() and j.peer_columns_fast_path_ok()
        assert vars(t.health_check()) == vars(j.health_check())
        for k in ("a_k1", "b_k2", "svc0_k7"):
            assert (t.get_peer(k).info.grpc_address
                    == j.get_peer(k).info.grpc_address)
    finally:
        await j.close()
        await t.close()


def _families(text):
    """Exposition blocks by family, comparable across processes: creation
    stamps and wall-clock durations blanked."""
    text = re.sub(r"(_created(\{[^}]*\})?) \S+", r"\1 T", text)
    out, cur = {}, None
    for ln in text.splitlines():
        if ln.startswith("# HELP "):
            cur = ln.split()[2]
            out[cur] = []
        if "duration" in cur and not ln.startswith("#"):
            if not re.match(r"\S+_count[{ ]", ln):
                continue  # sums and buckets of measured times
        out[cur].append(ln)
    return out


async def test_metrics_text_matches_the_jax_exposition(clock):
    """The same calls leave the same /metrics text on the families the
    port keeps; a call with GLOBAL items waits for both nodes' background
    re-read, so both count the same windows.  Empty tables: a load drops
    the rows already expired, so a loaded engine counts fewer keys than
    the one it came from."""
    j, t = await started(seed_state=False)
    try:
        rng = np.random.default_rng(5)
        for k in range(6):
            clock["now"] = NOW + 1000 * k
            fields = items(rng, 30, k, objects=k % 2 == 1)
            if k % 2:
                before = broadcasts(j, t)
                await j.get_rate_limits([JRequest(**f) for f in fields])
                await t.get_rate_limits(
                    [RateLimitRequest(**f) for f in fields])
                if has_global_hits(fields):
                    await settled(j, t, before=before)
            else:
                await j.get_rate_limits_columns(jcolumns(fields))
                await t.get_rate_limits_columns(columns(ReqColumns, fields))
    finally:
        await j.close()
        await t.close()
    jt = _families(j.metrics.expose().decode())
    pt = _families(t.metrics.expose().decode())
    assert set(pt) <= set(jt)
    assert [k for k in jt if k in pt] == list(pt)  # registration order
    for fam in pt:
        if fam.startswith("gubernator_build_info"):
            continue  # the port's version labels
        assert pt[fam] == jt[fam], fam


# ----------------------------------------------------------------------
# The daemons over loopback gRPC and HTTP
# ----------------------------------------------------------------------
def raw_batches(rng):
    """Raw GetRateLimitsReq frames: plain ones (the fast path), one with
    per-item errors, one with GLOBAL items (both the object path)."""
    out = []
    for k in range(6):
        fields = items(rng, int(rng.integers(1, 80)), 50 + k, objects=False)
        if k == 4:
            fields[0]["name"] = ""
        if k == 5:
            fields = [dict(f, unique_key=f"g{k}_{i}", behavior=GLOBAL,
                           duration=3_600_000, limit=1000, algorithm=0)
                      for i, f in enumerate(fields)]
        msgs = []
        for f in fields:
            m = pb.RateLimitReq(**{x: v for x, v in f.items()
                                   if x != "created_at"})
            if f["created_at"] is not None:
                m.created_at = f["created_at"]
            msgs.append(m)
        out.append(pb.GetRateLimitsReq(requests=msgs).SerializeToString())
    return out


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


async def test_daemons_answer_the_same_bytes_and_json(clock):
    jconf = jconfig.DaemonConfig(
        grpc_listen_address="127.0.0.1:0",
        http_listen_address="127.0.0.1:0",
        config=jconfig.Config(cache_size=CAP, tpu_max_batch=WIDTH))
    tconf = config.DaemonConfig(
        grpc_listen_address="127.0.0.1:0",
        http_listen_address="127.0.0.1:0",
        config=config.Config(cache_size=CAP, tpu_max_batch=WIDTH,
                             tpu_platform="cpu"))
    jd = await jdaemon.spawn_daemon(
        jconf, engine=JaxEngine(capacity=CAP, max_batch=WIDTH))
    td = await daemon.spawn_daemon(tconf)
    jc, tc = jd.client(), td.client()
    try:
        for raw in raw_batches(np.random.default_rng(3)):
            want = await jc._raw_get_rate_limits(raw, timeout=30)
            got = await tc.get_rate_limits_raw(raw)
            assert got == want
        body = json.dumps({"requests": [
            {"name": "http", "unique_key": f"h{i % 3}", "hits": "1",
             "limit": "10", "duration": "60000", "created_at": str(NOW)}
            for i in range(5)] + [{"name": "", "unique_key": "x"}]}).encode()
        for _ in range(2):
            want = await asyncio.to_thread(
                _post, f"http://{jd.conf.http_listen_address}"
                "/v1/GetRateLimits", body)
            got = await asyncio.to_thread(
                _post, f"http://{td.conf.http_listen_address}"
                "/v1/GetRateLimits", body)
            assert got == want
        for path in ("/v1/HealthCheck", "/readyz"):
            want = await asyncio.to_thread(
                _get, f"http://{jd.conf.http_listen_address}{path}")
            got = await asyncio.to_thread(
                _get, f"http://{td.conf.http_listen_address}{path}")
            assert got == want, path
        h = await tc.health_check()
        assert (h.status, h.peer_count) == ("healthy", 1)
        # The columnar client, and PeersV1 through the JAX package's stub
        # (the same method paths): a relayed batch and a GLOBAL install.
        fields = items(np.random.default_rng(4), 30, 70, objects=False)
        want = await jc.get_rate_limits_columns(jcolumns(fields))
        got = await tc.get_rate_limits_columns(columns(ReqColumns, fields))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        from gubernator_tpu.pb import peers_pb2
        from gubernator_tpu.transport.grpc_api import PeersV1Stub

        relayed = peers_pb2.GetPeerRateLimitsReq.FromString(raw_batches(
            np.random.default_rng(8))[5])
        install = peers_pb2.UpdatePeerGlobalsReq(globals=[
            peers_pb2.UpdatePeerGlobal(
                key=f"upd_k{i}", algorithm=0, duration=60_000,
                created_at=NOW, status=pb.RateLimitResp(
                    limit=9, remaining=i, reset_time=NOW + 60_000))
            for i in range(3)])
        query = pb.GetRateLimitsReq(requests=[
            pb.RateLimitReq(name="upd", unique_key=f"k{i}", limit=9,
                            duration=60_000) for i in range(3)])
        answers = []
        for c in (jc, tc):
            stub = PeersV1Stub(c.channel)
            r = await stub.GetPeerRateLimits(relayed, timeout=30)
            await stub.UpdatePeerGlobals(install, timeout=30)
            q = await c.stub.GetRateLimits(query, timeout=30)
            answers.append((r.SerializeToString(), q.SerializeToString()))
        assert answers[0] == answers[1]
    finally:
        await jc.close()
        await tc.close()
        await jd.close()
        await td.close()
