"""The port's multi-region federation against the JAX package's.

Everything in ``gubernator_tpu_torch.federation`` is host code, so each
check runs the same seeded inputs through both packages and holds the
outcomes equal:

* envelope merges, the receive ledger (duplicates, failed applies, a
  restarted sender's fresh epoch) and the distinct-key bound;
* the ``GFE1`` / ``GFA1`` frames, byte for byte both ways, and the same
  malformed frames refused;
* the manager's channel discipline on the same scripted remote peers
  (stale ack, ring update mid-flight and mid-send, the sequence across a
  dropped channel, receive chunking, the laps rule, the pending bound,
  the staleness gauge, the batch limit, the final flush), driven through
  the manager's own methods with the flush loop parked;
* the ``GUBER_FEDERATION_*`` knob validation;
* ``MULTI_REGION`` refused per item on a node without federation, on
  the native and the protobuf decode path;
* on a federated port node: MULTI_REGION served as GLOBAL, degraded
  answers counted, an applied envelope never queued back (no laps), a
  ring change never pushing GLOBAL state to another region;
* the reshard interlock: no envelope is built between FREEZE and the
  end of the cutover, and sends resume after an abort;
* one 2-region cluster of each package (four daemons over loopback
  gRPC, the JAX one at the shapes ``tests/test_chaos.py`` compiles)
  through a healthy exchange, a WAN partition and a heal: equal landed
  counts in both regions, no hit lost.
"""

import asyncio
import random
import threading
from types import SimpleNamespace

import pytest

import chip_smoke as cs

T = 60  # seconds: the bound on every await of the cluster test


def pkg(which: str) -> SimpleNamespace:
    """One package's federation surface under common names."""
    if which == "jax":
        from gubernator_tpu import config, types
        from gubernator_tpu.federation import envelope, manager
        from gubernator_tpu.parallel import hashring
        from gubernator_tpu.resilience import ManualClock, ResilienceConfig
        from gubernator_tpu.transport import fastwire
        from gubernator_tpu.utils.metrics import Metrics
    else:
        from gubernator_tpu_torch import config, types
        from gubernator_tpu_torch.federation import envelope, manager
        from gubernator_tpu_torch.parallel import hashring
        from gubernator_tpu_torch.resilience import (
            ManualClock, ResilienceConfig)
        from gubernator_tpu_torch.transport import fastwire
        from gubernator_tpu_torch.utils.metrics import Metrics
    return SimpleNamespace(
        config=config, types=types, envelope=envelope, manager=manager,
        hashring=hashring, ManualClock=ManualClock,
        ResilienceConfig=ResilienceConfig, fastwire=fastwire,
        Metrics=Metrics)


BOTH = ("jax", "port")


def rec(P, key, hits, behavior=0, **kw):
    return P.envelope.FederationRecord(
        name="fed", unique_key=key, hits=hits, limit=kw.pop("limit", 1000),
        duration=60_000, behavior=behavior, **kw)


def env_tuple(env):
    return (env.origin, env.region, env.epoch, env.seq,
            [tuple(vars(r).values()) for r in env.records])


# ----------------------------------------------------------------------
# Envelopes, the ledger and the bound
# ----------------------------------------------------------------------
def merge_fuzz(P, seed):
    """The reference's fuzz: numbered streams from three origins applied
    in random interleavings with random redeliveries of delivered
    envelopes, through one ledger a trial."""
    rng = random.Random(seed)
    origins = ["node-a:81", "node-b:81", "node-c:81"]
    keys = [f"k{i}" for i in range(6)]
    streams, expected = {}, {k: 0 for k in keys}
    for origin in origins:
        envs = []
        for seq in range(1, rng.randint(4, 9)):
            records = [rec(P, k, rng.randint(-2, 7))
                       for k in rng.sample(keys, rng.randint(1, len(keys)))]
            for r in records:
                expected[r.unique_key] += r.hits
            envs.append(P.envelope.FederationEnvelope(
                origin=origin, region="us", epoch=rng.choice(["e1", "e2"]),
                seq=seq, records=records))
        streams[origin] = envs
    trials = []
    for _ in range(12):
        cursors = {o: 0 for o in origins}
        ledger = P.envelope.ReceiveLedger()
        totals = {k: 0 for k in keys}
        admitted = []
        while any(cursors[o] < len(streams[o]) for o in origins):
            o = rng.choice(origins)
            picks = []
            if cursors[o] < len(streams[o]):
                picks.append(streams[o][cursors[o]])
                cursors[o] += 1
            if rng.random() < 0.5:
                od = rng.choice(origins)
                if cursors[od]:
                    picks.append(streams[od][rng.randrange(cursors[od])])
            for env in picks:
                ok = ledger.admit(env)
                admitted.append(ok)
                if ok:
                    for r in env.records:
                        totals[r.unique_key] += r.hits
        trials.append((totals, admitted, dict(ledger._last)))
    return expected, trials


@pytest.mark.parametrize("seed", [20260807, 1, 2, 3])
def test_envelope_merge_fuzz_matches_jax(seed):
    want = merge_fuzz(pkg("jax"), seed)
    got = merge_fuzz(pkg("port"), seed)
    assert got == want
    expected, trials = got
    for totals, _, _ in trials:
        assert totals == expected


@pytest.mark.parametrize("seed", range(3))
def test_record_merge_matches_jax(seed):
    """Hits add, the limit config is the last writer's, RESET is ORed and
    never cleared."""
    outs = []
    for which in BOTH:
        P = pkg(which)
        rng = random.Random(seed)
        a = rec(P, "k", rng.randint(1, 9))
        trace = []
        for _ in range(8):
            b = P.envelope.FederationRecord(
                name="fed", unique_key="k", hits=rng.randint(-3, 9),
                limit=rng.randint(1, 100), duration=rng.randint(1, 10**6),
                algorithm=rng.randint(0, 4),
                behavior=rng.choice([0, 2, 8, 8 | 2, 32]),
                burst=rng.randint(0, 9), created_at=rng.randint(0, 10**9))
            a.merge(b)
            trace.append(tuple(vars(a).values()))
        outs.append(trace)
    assert outs[0] == outs[1]
    assert any(t[6] & 8 for t in outs[1])


def ledger_script(P):
    """Failed apply, retry, lost ack, a restarted sender and a straggler
    of the dead epoch, as seen / mark / admit / last calls."""
    E = P.envelope
    led = E.ReceiveLedger()
    one = E.FederationEnvelope(origin="o:1", seq=1, records=[rec(P, "k", 2)])
    out = [led.seen(one), led.seen(one)]          # apply fails: no mark
    led.mark(one)
    out += [led.seen(one), led.last("o:1")]
    old = E.FederationEnvelope(origin="o:1", epoch="boot-1", seq=7)
    reborn = E.FederationEnvelope(origin="o:1", epoch="boot-2", seq=1)
    out += [led.admit(old), led.last("o:1", "boot-1"), led.seen(reborn),
            led.admit(reborn), led.last("o:1", "boot-2"), led.seen(old),
            led.seen(reborn), led.admit(old)]
    led.mark(E.FederationEnvelope(origin="o:1", epoch="boot-2", seq=3))
    led.mark(E.FederationEnvelope(origin="o:1", epoch="boot-2", seq=2))
    out += [led.last("o:1", "boot-2"), sorted(led._last.items())]
    return out


def test_ledger_cases_match_jax():
    got = ledger_script(pkg("port"))
    assert got == ledger_script(pkg("jax"))
    assert got[:4] == [False, False, True, 1]
    assert got[4:12] == [True, 7, False, True, 1, True, True, False]


@pytest.mark.parametrize("limit", [1, 2, 3, 5])
def test_merge_records_bound_matches_jax(limit):
    """A full buffer drops new keys only; a tracked key always absorbs
    its delta."""
    outs = []
    for which in BOTH:
        P = pkg(which)
        rng = random.Random(limit)
        into, trace = {}, []
        for _ in range(6):
            batch = [rec(P, f"k{rng.randint(0, 6)}", rng.randint(1, 5))
                     for _ in range(rng.randint(1, 4))]
            trace.append(P.envelope.merge_records(into, batch, limit))
        trace.append(sorted((k, v.hits) for k, v in into.items()))
        outs.append(trace)
    assert outs[0] == outs[1]
    assert len(outs[1][-1]) <= limit


# ----------------------------------------------------------------------
# Frames
# ----------------------------------------------------------------------
def random_envelope(P, rng, n):
    names = ["fed", "Ω≈", "", "ключ", "a" * 300]
    return P.envelope.FederationEnvelope(
        origin=f"10.0.0.{rng.randint(1, 9)}:81", region=rng.choice(
            ["us", "eu", "ap-south"]), epoch=f"{rng.getrandbits(64):016x}",
        seq=rng.randint(1, 2**62), records=[
            P.envelope.FederationRecord(
                name=rng.choice(names), unique_key=rng.choice(names) + str(i),
                hits=rng.randint(-2**40, 2**40), limit=rng.choice(
                    [0, 1, 2**62, -5]), duration=rng.randint(0, 2**40),
                algorithm=rng.randint(0, 4), behavior=rng.randint(0, 63),
                burst=rng.randint(0, 99), created_at=rng.randint(0, 2**50))
            for i in range(n)])


@pytest.mark.parametrize("n", [0, 1, 7, 1000])
def test_federation_frames_equal_the_jax_bytes(n):
    J, P = pkg("jax"), pkg("port")
    je = random_envelope(J, random.Random(n), n)
    pe = random_envelope(P, random.Random(n), n)
    jb = J.fastwire.encode_federation_envelope(je)
    pb = P.fastwire.encode_federation_envelope(pe)
    assert pb == jb
    back = P.fastwire.parse_federation_envelope(jb)
    assert back == pe and env_tuple(back) == env_tuple(je)
    assert env_tuple(J.fastwire.parse_federation_envelope(pb)) == \
        env_tuple(pe)
    ja = J.envelope.FederationAck(origin=je.origin, seq=je.seq, applied=n)
    pa = P.envelope.FederationAck(origin=pe.origin, seq=pe.seq, applied=n)
    assert P.fastwire.encode_federation_ack(pa) == \
        J.fastwire.encode_federation_ack(ja)
    assert P.fastwire.parse_federation_ack(
        J.fastwire.encode_federation_ack(ja)) == pa


def test_malformed_federation_frames_refused_alike():
    J, P = pkg("jax"), pkg("port")
    data = J.fastwire.encode_federation_envelope(
        random_envelope(J, random.Random(9), 3))
    ack = J.fastwire.encode_federation_ack(
        J.envelope.FederationAck(origin="o:1", seq=3, applied=2))
    bad = [b"", b"XXXX" + data[4:], data + b"\0", ack, b"GFA1\x01",
           b"GFE1" + b"\xff" * 20] + [data[:k] for k in range(0, len(data),
                                                               7)]
    for frame in bad:
        assert P.fastwire.parse_federation_envelope(frame) is None
        assert J.fastwire.parse_federation_envelope(frame) is None
    for frame in [ack[:k] for k in range(len(ack))] + [ack + b"\0", data]:
        assert P.fastwire.parse_federation_ack(frame) is None
        assert J.fastwire.parse_federation_ack(frame) is None


# ----------------------------------------------------------------------
# The manager's channel discipline (scripted remote peers)
# ----------------------------------------------------------------------
class FakePeer:
    """A remote-region PeerClient stand-in: records envelopes, fails on
    demand, acks ``seq + ack_offset``; ``gate`` parks the RPC."""

    def __init__(self, P, addr, dc="eu"):
        self.P = P
        self.info = P.types.PeerInfo(grpc_address=addr, datacenter=dc)
        self.received, self.fail, self.ack_offset = [], False, 0
        self.gate, self.fail_after_gate = None, False

    async def federation_sync(self, env, timeout=None):
        if self.gate is not None:
            await self.gate.wait()
            if self.fail_after_gate:
                raise RuntimeError("died mid-drain")
        if self.fail:
            raise RuntimeError("wan down")
        self.received.append(env_tuple(env))
        return self.P.envelope.FederationAck(
            origin=env.origin, seq=env.seq + self.ack_offset,
            applied=len(env.records))


def picker(P, peers):
    rp = P.hashring.RegionPicker()
    for p in peers:
        rp.add(p)
    return rp


def fake_instance(P, peers, home="us", batch_limit=1000, redelivery=10_000):
    inst = SimpleNamespace(
        conf=SimpleNamespace(
            data_center=home, advertise_address="self:81",
            federation_interval=60.0, federation_batch_limit=batch_limit,
            federation_timeout=0.5,
            resilience=P.ResilienceConfig(redelivery_limit=redelivery)),
        region_picker=picker(P, peers), applied=[])

    async def apply(reqs):
        inst.applied.append([(r.name, r.unique_key, r.hits, int(r.behavior),
                              dict(r.metadata), r.created_at) for r in reqs])

    inst.get_peer_rate_limits = apply
    return inst


def mr(P, key="k", hits=3, **kw):
    return P.types.RateLimitRequest(name="fed", unique_key=key, hits=hits,
                                    limit=100, duration=60_000, **kw)


def manager(P, inst, **kw):
    return P.manager.FederationManager(inst, epoch="boot-1", **kw)


async def sc_stale_ack(P):
    peer = FakePeer(P, "eu-1:81")
    fed = manager(P, fake_instance(P, [peer]))
    try:
        peer.ack_offset = -1
        fed.queue(mr(P))
        await fed._flush_once(force_retry=True)
        (ch,) = fed._channels.values()
        out = [ch.failing, ch.inflight is not None, ch.next_try > 0,
               fed.is_degraded()]
        peer.ack_offset = 0
        await fed._flush_once(force_retry=True)
        out += [ch.inflight is None, ch.failing, fed.is_degraded(),
                peer.received]
        assert out[:7] == [True, True, True, True, True, False, False]
        assert [e[3] for e in peer.received] == [1, 1]
        return out
    finally:
        await fed.close()


async def sc_ring_update_reroutes(P):
    dead = FakePeer(P, "eu-1:81")
    dead.fail = True
    inst = fake_instance(P, [dead])
    fed = manager(P, inst)
    try:
        fed.queue(mr(P, hits=3))
        await fed._flush_once(force_retry=True)
        out = [fed.inflight_envelopes(), fed.is_degraded()]
        heir = FakePeer(P, "eu-2:81")
        inst.region_picker = picker(P, [heir])
        fed.on_ring_update()
        out += [sorted(fed._channels), fed.is_degraded(),
                fed.pending_keys()]
        await fed._flush_once(force_retry=True)
        out += [heir.received, fed.pending_keys(), fed.inflight_envelopes()]
        assert out[:5] == [1, True, [], False, 1]
        assert [(e[3], e[4][0][2]) for e in heir.received] == [(1, 3)]
        return out
    finally:
        await fed.close()


async def mid_send(P, fail):
    peer = FakePeer(P, "eu-1:81")
    peer.gate, peer.fail_after_gate = asyncio.Event(), fail
    inst = fake_instance(P, [peer])
    fed = manager(P, inst)
    try:
        fed.queue(mr(P))
        task = asyncio.ensure_future(fed._flush_once(force_retry=True))
        while not any(ch.sending for ch in fed._channels.values()):
            await asyncio.sleep(0)
        inst.region_picker = P.hashring.RegionPicker()  # the peer leaves
        fed.on_ring_update()
        out = [sorted(fed._channels), fed.pending_keys(),
               sorted(fed._orphans)]
        inst.region_picker = picker(P, [peer])           # and rejoins
        fed.queue(mr(P, "other-key"))
        fed._compact("eu", fed._pending["eu"])
        out.append(sorted(fed._channels))
        peer.gate.set()
        await task
        out += [sorted(fed._orphans), fed.pending_keys(), peer.received]
        assert out[:5] == [[], 0, ["eu-1:81"], [], []]
        assert out[5] == (2 if fail else 1)
        assert len(peer.received) == (0 if fail else 1)
        return out
    finally:
        await fed.close()


async def sc_mid_send_ok(P):
    return await mid_send(P, False)


async def sc_mid_send_fail(P):
    return await mid_send(P, True)


async def sc_seq_across_drop(P):
    peer = FakePeer(P, "eu-1:81")
    inst = fake_instance(P, [peer])
    fed = manager(P, inst)
    try:
        fed.queue(mr(P))
        await fed._flush_once(force_retry=True)
        inst.region_picker = P.hashring.RegionPicker()
        fed.on_ring_update()
        out = [sorted(fed._channels)]
        inst.region_picker = picker(P, [peer])
        fed.queue(mr(P, hits=1))
        await fed._flush_once(force_retry=True)
        out.append(peer.received)
        assert [(e[2], e[3]) for e in peer.received] == [
            ("boot-1", 1), ("boot-1", 2)]
        return out
    finally:
        await fed.close()


async def sc_receive_chunks(P):
    """An envelope over the peer batch limit applies in chunks, as
    GLOBAL requests tagged with their origin region; its redelivery is
    acked and applied nowhere."""
    inst = fake_instance(P, [FakePeer(P, "eu-1:81")])
    m = P.Metrics()
    fed = manager(P, inst, metrics=m)
    try:
        n = P.types.MAX_BATCH_SIZE + 5
        env = P.envelope.FederationEnvelope(
            origin="o:1", region="eu", epoch="e1", seq=1,
            records=[rec(P, f"k{i}", 1 + i % 3, behavior=8 * (i % 2),
                         created_at=i % 4) for i in range(n)])
        acks = [await fed.receive(env), await fed.receive(env)]
        out = [[vars(a) for a in acks], [len(b) for b in inst.applied],
               inst.applied[1], inst.applied[0][:4], fed.ledger.seen(env),
               [m.sample("gubernator_tpu_federation_envelopes_total",
                         {"result": r}) for r in ("applied", "duplicate")]]
        assert out[1] == [P.types.MAX_BATCH_SIZE, 5]
        assert [a["applied"] for a in out[0]] == [n, 0]
        assert all(r[4] == {P.manager.FED_ORIGIN_KEY: "eu"}
                   and r[3] & int(P.types.Behavior.GLOBAL)
                   for b in inst.applied for r in b)
        return out
    finally:
        await fed.close()


async def sc_queue_rules(P):
    """Zero hits and requests applied from a peer region are never
    queued (no laps); every remote region gets the delta, the home
    region none."""
    peers = [FakePeer(P, "eu-1:81"), FakePeer(P, "ap-1:81", "ap"),
             FakePeer(P, "us-2:81", "us")]
    fed = manager(P, fake_instance(P, peers))
    try:
        fed.queue(mr(P, hits=0))
        fed.queue(mr(P, metadata={P.manager.FED_ORIGIN_KEY: "eu"}))
        out = [fed.pending_keys()]
        fed.queue(mr(P, "a", 2))
        fed.queue(mr(P, "a", 5,
                     behavior=int(P.types.Behavior.RESET_REMAINING)))
        fed.queue(mr(P, "b", -1))
        out.append({r: sorted((k, v.hits, v.behavior) for k, v in p.items())
                    for r, p in fed._pending.items()})
        await fed._flush_once(force_retry=True)
        out += [peers[0].received, peers[1].received, peers[2].received]
        assert out[0] == 0 and sorted(out[1]) == ["ap", "eu"]
        assert peers[2].received == []
        return out
    finally:
        await fed.close()


async def sc_pending_bound(P):
    """The pending buffer holds at most GUBER_REDELIVERY_LIMIT distinct
    keys a region; tracked keys keep absorbing hits."""
    peer = FakePeer(P, "eu-1:81")
    peer.fail = True
    fed = manager(P, fake_instance(P, [peer], redelivery=3))
    try:
        for i in range(5):
            fed.queue(mr(P, f"k{i}", 1))
        fed.queue(mr(P, "k0", 4))
        out = [fed.pending_keys(),
               sorted((k, v.hits) for k, v in fed._pending["eu"].items())]
        assert out == [3, [("fed_k0", 5), ("fed_k1", 1), ("fed_k2", 1)]]
        return out
    finally:
        await fed.close()


async def sc_staleness_and_batch_limit(P):
    """The staleness gauge reads the oldest un-acked delta on the injected
    clock; an envelope carries at most the batch limit, one in flight a
    channel, the rest staying pending for the next sequence."""
    clock = P.ManualClock(100.0)
    m = P.Metrics()
    peer = FakePeer(P, "eu-1:81")
    peer.fail = True
    fed = manager(P, fake_instance(P, [peer], batch_limit=2), metrics=m,
                  clock=clock)

    def gauge():
        fed._update_staleness()
        return m.sample("gubernator_tpu_federation_staleness_seconds")

    try:
        out = [gauge()]
        for i in range(5):
            fed.queue(mr(P, f"k{i}", i + 1))
        clock.advance(2.5)
        out.append(gauge())
        await fed._flush_once(force_retry=True)
        clock.advance(1.0)
        out += [gauge(), fed.pending_keys(), fed.inflight_envelopes(),
                fed.is_degraded(),
                m.sample("gubernator_tpu_federation_redeliveries_total")]
        peer.fail = False
        for _ in range(4):
            await fed._flush_once(force_retry=True)
        out += [gauge(), [(e[3], len(e[4])) for e in peer.received],
                m.sample("gubernator_tpu_federation_envelopes_total",
                         {"result": "sent"})]
        assert out[:6] == [0.0, 2.5, 3.5, 3, 1, True]
        assert out[-2] == [(1, 2), (2, 2), (3, 1)] and out[-3] == 0.0
        return out
    finally:
        await fed.close()


async def sc_final_flush_on_close(P):
    peer = FakePeer(P, "eu-1:81")
    fed = manager(P, fake_instance(P, [peer]))
    for i in range(3):
        fed.queue(mr(P, f"k{i}", 1))
    await fed.close(drain_timeout=5.0)
    assert len(peer.received) == 1 and fed.pending_keys() == 0
    return [peer.received, fed._task.done()]


SCENARIOS = [sc_stale_ack, sc_ring_update_reroutes, sc_mid_send_ok,
             sc_mid_send_fail, sc_seq_across_drop, sc_receive_chunks,
             sc_queue_rules, sc_pending_bound, sc_staleness_and_batch_limit,
             sc_final_flush_on_close]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
def test_manager_scenario_matches_jax(scenario):
    want = asyncio.run(scenario(pkg("jax")))
    got = asyncio.run(scenario(pkg("port")))
    assert got == want


# ----------------------------------------------------------------------
# Knobs
# ----------------------------------------------------------------------
KNOB_CASES = [
    {"GUBER_FEDERATION_ENABLED": "true"},
    {"GUBER_FEDERATION_ENABLED": "true", "GUBER_DATA_CENTER": "us-east-1",
     "GUBER_FEDERATION_INTERVAL": "250ms"},
    {"GUBER_FEDERATION_BATCH_LIMIT": "1001"},
    {"GUBER_FEDERATION_BATCH_LIMIT": "0"},
    {"GUBER_FEDERATION_BATCH_LIMIT": "1000", "GUBER_FEDERATION_TIMEOUT": "2s"},
    {"GUBER_FEDERATION_INTERVAL": "0"},
    {"GUBER_FEDERATION_TIMEOUT": "-1s"},
    {"GUBER_DATA_CENTER": "eu", "GUBER_FEDERATION_BATCH_LIMIT": "1"},
]


@pytest.mark.parametrize("env", KNOB_CASES,
                         ids=[str(i) for i in range(len(KNOB_CASES))])
def test_federation_knobs_validate_as_jax(env):
    outs = []
    for which in BOTH:
        try:
            c = pkg(which).config.setup_daemon_config(environ=env).config
            outs.append(("ok", c.federation_enabled, c.federation_interval,
                         c.federation_batch_limit, c.federation_timeout,
                         c.data_center))
        except ValueError as e:
            outs.append(("error", str(e)))
    assert outs[0] == outs[1]


# ----------------------------------------------------------------------
# MULTI_REGION at the edge
# ----------------------------------------------------------------------
def multi_region_batch(pb, Behavior):
    return [pb.RateLimitReq(name="mr", unique_key="k", hits=1, limit=10,
                            duration=60_000,
                            behavior=int(Behavior.MULTI_REGION)),
            pb.RateLimitReq(name="plain", unique_key="k", hits=1, limit=10,
                            duration=60_000)]


def test_multi_region_is_special_on_both_decode_paths():
    from gubernator_tpu_torch.pb import gubernator_pb2 as pb
    from gubernator_tpu_torch.transport import convert, fastwire
    from gubernator_tpu_torch.types import Behavior

    ms = multi_region_batch(pb, Behavior)
    _, errors, special = convert.columns_from_pb(ms)
    assert not errors and special
    _, errors, special = fastwire.parse_req(
        pb.GetRateLimitsReq(requests=ms).SerializeToString())
    assert not errors and special


async def test_multi_region_refused_per_item_without_federation():
    """The JAX instance's answer, item for item; then a port daemon
    refuses the item on its gRPC edge (native decode) and its JSON
    gateway (protobuf decode), serving the batch's other item."""
    import json
    import urllib.request

    from gubernator_tpu.service.instance import (
        InstanceConfig as JConfig, V1Instance as JInstance)
    from gubernator_tpu.types import RateLimitRequest as JRequest
    from gubernator_tpu_torch.config import Config, DaemonConfig
    from gubernator_tpu_torch.pb import gubernator_pb2 as pb
    from gubernator_tpu_torch.service.instance import (
        InstanceConfig, V1Instance)
    from gubernator_tpu_torch.transport.daemon import spawn_daemon
    from gubernator_tpu_torch.types import Behavior, RateLimitRequest

    fields = [dict(name="mr", unique_key="k", hits=1, limit=10,
                   duration=60_000, behavior=int(Behavior.MULTI_REGION)),
              dict(name="plain", unique_key="k", hits=1, limit=10,
                   duration=60_000)]
    ji = await JInstance.create(JConfig(cache_size=256))
    ti = await V1Instance.create(InstanceConfig(
        cache_size=256, tpu_max_batch=64, tpu_platform="cpu"))
    try:
        want = await ji.get_rate_limits([JRequest(**f) for f in fields])
        got = await ti.get_rate_limits([RateLimitRequest(**f)
                                        for f in fields])
        assert ti.federation is None
        assert [(r.error, r.remaining) for r in got] == \
            [(r.error, r.remaining) for r in want]
        assert "MULTI_REGION requires" in got[0].error
        assert (ti.metrics.sample("gubernator_check_error_counter_total",
                                  {"error": "Invalid request"})
                == ji.metrics.sample("gubernator_check_error_counter_total",
                                     {"error": "Invalid request"}) == 1)
    finally:
        await ti.close()
        await ji.close()

    d = await asyncio.wait_for(spawn_daemon(DaemonConfig(
        grpc_listen_address="127.0.0.1:0",
        http_listen_address="127.0.0.1:0",
        config=Config(cache_size=256, tpu_max_batch=64,
                      tpu_platform="cpu"))), 30)
    try:
        assert d.instance.columns_fast_path_ok()
        client = d.client()
        try:
            raw = await client.get_rate_limits_raw(pb.GetRateLimitsReq(
                requests=multi_region_batch(pb, Behavior))
                .SerializeToString(), timeout=30)
        finally:
            await client.close()
        rs = pb.GetRateLimitsResp.FromString(raw).responses
        assert "MULTI_REGION requires" in rs[0].error
        assert (rs[1].error, rs[1].remaining) == ("", 9)
        body = json.dumps({"requests": [
            {"name": "mr", "unique_key": "j", "hits": 1, "limit": 10,
             "duration": 60_000, "behavior": "MULTI_REGION"},
            {"name": "plain", "unique_key": "j", "hits": 1, "limit": 10,
             "duration": 60_000}]}).encode()

        def post():
            rq = urllib.request.Request(
                f"http://{d.conf.http_listen_address}/v1/GetRateLimits",
                data=body, method="POST")
            with urllib.request.urlopen(rq, timeout=30) as r:
                return json.loads(r.read())

        rs = (await asyncio.to_thread(post))["responses"]
        assert "MULTI_REGION requires" in rs[0]["error"]
        assert (rs[1]["error"], rs[1]["remaining"]) == ("", "9")
    finally:
        await d.close()


async def test_federated_node_serves_multi_region_as_global():
    """A node with federation answers MULTI_REGION from local state as a
    GLOBAL item, counts degraded answers while a remote region's channel
    fails, and wires its manager into the GLOBAL manager and the reshard
    coordinator."""
    from gubernator_tpu_torch.service.instance import (
        InstanceConfig, V1Instance)
    from gubernator_tpu_torch.types import Behavior, RateLimitRequest

    inst = await V1Instance.create(InstanceConfig(
        cache_size=256, tpu_max_batch=64, tpu_platform="cpu",
        data_center="us", federation_enabled=True,
        federation_interval=60.0))
    try:
        fed = inst.federation
        assert fed is not None
        assert inst.global_mgr.federation is fed
        assert inst.reshard_coord.federation is fed
        r = RateLimitRequest(name="mr", unique_key="k", hits=2, limit=10,
                             duration=60_000,
                             behavior=int(Behavior.MULTI_REGION))
        (out,) = await inst.get_rate_limits([r])
        assert (out.error, out.remaining) == ("", 8)
        assert r.behavior & int(Behavior.GLOBAL)
        assert inst.metrics.sample(
            "gubernator_tpu_federation_degraded_answers_total") == 0
        fed._channels["eu-1:81"] = SimpleNamespace(
            failing=True, peer=None, inflight=None)
        await inst.get_rate_limits([RateLimitRequest(
            name="mr", unique_key="k", hits=1, limit=10, duration=60_000,
            behavior=int(Behavior.MULTI_REGION))])
        assert inst.metrics.sample(
            "gubernator_tpu_federation_degraded_answers_total") == 1
        del fed._channels["eu-1:81"]
    finally:
        await inst.close()


async def test_applied_envelopes_never_lap():
    """On a federated node with a peer region, an owner-side MULTI_REGION
    hit is queued for that region; an envelope received from it applies
    its hits through ``get_peer_rate_limits`` and the GLOBAL manager, but
    its requests carry their origin and are never queued back."""
    from gubernator_tpu_torch.federation import (
        FederationEnvelope, FederationRecord)
    from gubernator_tpu_torch.service.instance import (
        InstanceConfig, V1Instance)
    from gubernator_tpu_torch.types import (
        Behavior, PeerInfo, RateLimitRequest)

    me = "127.0.0.1:9101"
    inst = await V1Instance.create(InstanceConfig(
        cache_size=256, tpu_max_batch=64, tpu_platform="cpu",
        data_center="us", advertise_address=me, federation_enabled=True,
        federation_interval=60.0, drain_timeout=0.5))
    try:
        inst.set_peers([PeerInfo(grpc_address=me, datacenter="us"),
                        PeerInfo(grpc_address="127.0.0.1:9", datacenter="eu")])
        fed = inst.federation
        mr_bit = int(Behavior.MULTI_REGION)
        (r,) = await inst.get_rate_limits([RateLimitRequest(
            name="lap", unique_key="a", hits=2, limit=10, duration=60_000,
            behavior=mr_bit)])
        assert (r.error, r.remaining) == ("", 8)
        assert fed.pending_keys() == 1
        ack = await fed.receive(FederationEnvelope(
            origin="127.0.0.1:9", region="eu", epoch="e", seq=1, records=[
                FederationRecord(name="lap", unique_key=k, hits=3, limit=10,
                                 duration=60_000, behavior=mr_bit)
                for k in ("a", "b")]))
        assert ack.applied == 2
        assert sorted(fed._pending["eu"]) == ["lap_a"]
        assert fed._pending["eu"]["lap_a"].hits == 2
        assert {"lap_a", "lap_b"} <= set(inst.global_mgr._owned)
        out = await inst.get_rate_limits([RateLimitRequest(
            name="lap", unique_key=k, hits=0, limit=10, duration=60_000,
            behavior=mr_bit) for k in ("a", "b")])
        assert [o.remaining for o in out] == [5, 7]
    finally:
        await inst.close()


async def test_transfer_ownership_never_pushes_cross_region(monkeypatch):
    """A ring change hands GLOBAL state only to this region's new owners
    (the local picker); a peer of another region is never sent an
    UpdatePeerGlobals: regions converge through envelopes."""
    from gubernator_tpu_torch.service.instance import (
        InstanceConfig, V1Instance)
    from gubernator_tpu_torch.service.peer_client import PeerClient
    from gubernator_tpu_torch.types import (
        Behavior, PeerInfo, RateLimitRequest)

    me, us, eu = "127.0.0.1:9101", "127.0.0.1:9102", "127.0.0.1:9103"
    inst = await V1Instance.create(InstanceConfig(
        cache_size=256, tpu_max_batch=64, tpu_platform="cpu",
        data_center="us", advertise_address=me, drain_timeout=0.5))
    pushed = []

    async def spy(self, updates):
        pushed.append((self.info.grpc_address, len(updates)))

    monkeypatch.setattr(PeerClient, "update_peer_globals", spy)
    try:
        for i in range(24):
            r = RateLimitRequest(name="xfer", unique_key=f"k{i}", hits=2,
                                 limit=100, duration=60_000,
                                 behavior=int(Behavior.GLOBAL))
            inst.global_mgr._owned[r.hash_key()] = r
        inst.set_peers([PeerInfo(grpc_address=me, datacenter="us"),
                        PeerInfo(grpc_address=us, datacenter="us"),
                        PeerInfo(grpc_address=eu, datacenter="eu")])
        assert [p.info.grpc_address
                for p in inst.region_picker.peers()] == [eu]
        assert await inst.global_mgr.transfer_ownership() > 0
        assert pushed and all(addr == us for addr, _ in pushed), pushed
    finally:
        await inst.close()


# ----------------------------------------------------------------------
# The reshard interlock
# ----------------------------------------------------------------------
async def test_reshard_pauses_federation_no_envelope_from_half_relayout():
    """A flush tick while the engine is mid-relayout builds and sends
    nothing; the delta stays pending and the first tick after the commit
    sends it."""
    from gubernator_tpu_torch.parallel.reshard import ReshardCoordinator

    P = pkg("port")
    peer = FakePeer(P, "eu-1:81")
    fed = manager(P, fake_instance(P, [peer]), clock=P.ManualClock())
    in_cutover, release = threading.Event(), threading.Event()

    class HalfRelayoutEngine:
        n_shards = 2

        def cache_size(self):
            return 0

        def export_items(self):
            return []

        def reshard(self, new_shards):
            in_cutover.set()
            assert release.wait(5), "the cutover was never released"
            self.n_shards = new_shards
            return {"live_items": 0}

    coord = ReshardCoordinator(HalfRelayoutEngine(), federation=fed)
    try:
        loop = asyncio.get_running_loop()
        fut = loop.run_in_executor(None, coord.reshard, 4)
        await loop.run_in_executor(None, in_cutover.wait)
        fed.queue(mr(P, "k1"))
        await fed._flush_once(force_retry=True)
        assert peer.received == [] and not fed._channels
        assert fed.pending_keys() == 1
        release.set()
        assert (await fut)["outcome"] == "committed"
        await fed._flush_once(force_retry=True)
        assert [e[3] for e in peer.received] == [1]
    finally:
        release.set()
        await fed.close()


async def test_reshard_abort_resumes_federation_sends():
    from gubernator_tpu_torch.parallel.reshard import ReshardCoordinator

    P = pkg("port")
    peer = FakePeer(P, "eu-1:81")
    fed = manager(P, fake_instance(P, [peer]), clock=P.ManualClock())

    class ExplodingEngine:
        n_shards = 2

        def cache_size(self):
            return 0

        def export_items(self):
            return []

        def reshard(self, new_shards):
            raise RuntimeError("relayout failed (rolled back)")

    coord = ReshardCoordinator(ExplodingEngine(), federation=fed)
    try:
        fed.queue(mr(P, "k2"))
        out = await asyncio.get_running_loop().run_in_executor(
            None, coord.reshard, 4)
        assert out["outcome"] == "aborted" and not fed._paused
        await fed._flush_once(force_retry=True)
        assert [e[3] for e in peer.received] == [1]
    finally:
        await fed.close()


async def test_node_reshard_pauses_and_resumes_its_federation():
    """``V1Instance.reshard`` (the identity transition of a single-card
    engine) pauses the node's manager for the transition and resumes it
    after."""
    from gubernator_tpu_torch.service.instance import (
        InstanceConfig, V1Instance)

    inst = await V1Instance.create(InstanceConfig(
        cache_size=256, tpu_max_batch=64, tpu_platform="cpu",
        data_center="us", federation_enabled=True,
        federation_interval=60.0))
    calls = []
    fed = inst.federation
    pause, resume = fed.pause, fed.resume
    fed.pause = lambda: (calls.append(("pause", inst.reshard_coord.phase)),
                         pause())
    fed.resume = lambda: (calls.append(("resume", fed._paused)), resume())
    try:
        out = await inst.reshard(2)
        assert out["outcome"] == "committed"
        assert calls == [("pause", "freeze"), ("resume", True)]
        assert not fed._paused
    finally:
        await inst.close()


# ----------------------------------------------------------------------
# Two regions, a partition and a heal: the JAX cluster against the port's
# ----------------------------------------------------------------------
def isolate_regions(inj, c):
    for da in c.daemons:
        for db in c.daemons:
            if da.conf.data_center == "us" and db.conf.data_center == "eu":
                inj.set_fault(db.conf.grpc_listen_address,
                              from_peer=da.advertise_address, partition=True)
                inj.set_fault(da.conf.grpc_listen_address,
                              from_peer=db.advertise_address, partition=True)


async def drive_regions(c, make, inj, seed=31, keys=12, over_limit=6):
    """Healthy MULTI_REGION hits on ``keys`` keys from every node, a WAN
    partition with hits on both sides (the over key driven to OVER_LIMIT
    on each region's owner), a heal; returns the hits sent, the count
    each region's owner holds once both regions agree, and each region's
    admissions of the over key."""
    rng = random.Random(seed)
    names = [cs.spread_key(500 + i) for i in range(keys)]
    sent = {k: 0 for k in names}
    mr_bit = 16

    async def call(d, reqs):
        cl = d.client()
        try:
            return await asyncio.wait_for(cl.get_rate_limits(reqs, timeout=T),
                                          T)
        finally:
            await cl.close()

    async def hits(rounds):
        for j in range(rounds):
            pick = rng.sample(names, rng.randint(1, 4))
            reqs = [make(name="fed", unique_key=k, hits=rng.randint(1, 3),
                         limit=1_000_000, duration=3_600_000,
                         behavior=mr_bit) for k in pick]
            out = await call(c.daemons[j % len(c.daemons)], reqs)
            assert not any(r.error for r in out), [r.error for r in out]
            for r in reqs:
                sent[r.unique_key] += r.hits

    async def landed(region):
        out = {}
        for k in names:
            owner = c.find_owning_daemon_in_region("fed", k, region)
            (r,) = await call(owner, [make(
                name="fed", unique_key=k, hits=0, limit=1_000_000,
                duration=3_600_000, behavior=mr_bit)])
            out[k] = 1_000_000 - r.remaining
        return out

    async def converge():
        async def poll():
            while True:
                got = {r: await landed(r) for r in ("us", "eu")}
                if got["us"] == got["eu"] == sent:
                    return got
                await asyncio.sleep(0.05)
        try:
            return await asyncio.wait_for(poll(), T)
        except asyncio.TimeoutError:
            return {r: await landed(r) for r in ("us", "eu")}

    await hits(8)
    healthy = await converge()
    healthy_sent = dict(sent)
    isolate_regions(inj, c)
    await hits(8)
    admitted = {}
    for region in ("us", "eu"):
        owner = c.find_owning_daemon_in_region("fed", "over", region)
        admitted[region] = 0
        for _ in range(2 * over_limit):
            (r,) = await call(owner, [make(
                name="fed", unique_key="over", hits=1, limit=over_limit,
                duration=3_600_000, behavior=mr_bit)])
            assert r.error == ""
            if r.status == 1:
                break
            admitted[region] += 1
    inj.clear()
    healed = await converge()
    return {"sent": dict(sent), "healthy": healthy,
            "healthy_sent": healthy_sent, "healed": healed,
            "admitted": admitted}


async def test_two_region_cluster_heals_as_the_jax_cluster():
    from gubernator_tpu import cluster as jcluster
    from gubernator_tpu import config as jconfig
    from gubernator_tpu.resilience import (
        FaultInjector as JInjector, ResilienceConfig as JResilience)
    from gubernator_tpu.types import RateLimitRequest as JRequest
    from gubernator_tpu_torch.cluster import Cluster
    from gubernator_tpu_torch.config import BehaviorConfig
    from gubernator_tpu_torch.resilience import (
        FaultInjector, ResilienceConfig)
    from gubernator_tpu_torch.types import RateLimitRequest

    fast = dict(breaker_open_for=0.05, breaker_open_cap=0.1,
                breaker_min_requests=3, forward_backoff_base=0.002,
                forward_backoff_cap=0.02)
    dcs = ["us", "us", "eu", "eu"]
    results = []
    jinj = JInjector(seed=13)
    jc = await asyncio.wait_for(jcluster.Cluster.start(
        4, datacenters=dcs, behaviors=jconfig.BehaviorConfig(
            global_sync_wait=0.02, batch_wait=0.001, batch_timeout=T),
        resilience=JResilience(**fast), fault_injector=jinj,
        federation=True, federation_interval=0.02), T)
    try:
        results.append(await drive_regions(jc, JRequest, jinj))
    finally:
        await jc.stop()
    inj = FaultInjector(seed=13)
    pc = await asyncio.wait_for(Cluster.start(
        4, datacenters=dcs, behaviors=BehaviorConfig(
            global_sync_wait=0.02, batch_wait=0.001, batch_timeout=T),
        resilience=ResilienceConfig(**fast), fault_injector=inj,
        federation=True, federation_interval=0.02, tpu_platform="cpu",
        cache_size=1024, tpu_max_batch=64), T)
    try:
        results.append(await drive_regions(pc, RateLimitRequest, inj))
        redeliveries = sum(d.metrics.sample(
            "gubernator_tpu_federation_redeliveries_total")
            for d in pc.daemons)
        pending = [d.instance.federation.pending_keys() for d in pc.daemons]
    finally:
        await pc.stop()
    want, got = results
    assert got == want
    for r in ("us", "eu"):
        assert got["healthy"][r] == got["healthy_sent"]
        assert got["healed"][r] == got["sent"]
    # Each isolated region admits the over key's limit once: the
    # over-admission ratio of a 2-region split is at most 1.0.
    assert sum(got["admitted"].values()) <= 2 * 6
    assert redeliveries > 0 and pending == [0, 0, 0, 0]
