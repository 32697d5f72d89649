"""The port's quota-lease tier against the JAX package's.

* Lease frames, v1 and v2, requests and responses: byte for byte the
  same encodings, each package parses the other's, both reject the same
  malformed frames.
* Signing: ``lease_payload`` and HMAC tokens byte-equal, ed25519 tokens
  verifying across the packages, the same tampered tokens rejected, and
  the no-``cryptography`` path.
* ``LeaseCache`` on a ManualClock: seeded sequences of admissions,
  expiry, config changes, offline extension under a raising grant,
  ``take_syncs`` / ``note_synced`` and ``close`` give the same verdicts
  and ``stats()``.
* ``LeaseManager``: ``chip_smoke.lease_sequence`` on the JAX package over
  ``tests.helpers.Sim``'s engine and on the port over a CPU ``TickEngine``
  of the same size: tokens, acks, ``stats()``, lease columns, probes and
  the exported tables equal.
* The service: ``TickLoop.under_pressure``, a CPU ``V1Instance`` granting
  and syncing through its tick loop, and a CPU mesh node (no lease
  columns) doing the same.

The JAX side uses only ``Sim``'s engine shape (capacity 1024, max_batch
64) and pure-Python modules; everything else is the port on the CPU.
"""

import asyncio
import dataclasses
import struct

import numpy as np
import pytest

import chip_smoke as cs
from gubernator_tpu import leases as jl
from gubernator_tpu import types as jtypes
from gubernator_tpu.resilience.clock import ManualClock as JClock
from gubernator_tpu.transport import fastwire as jfw
from gubernator_tpu_torch import leases as tl
from gubernator_tpu_torch import types as ttypes
from gubernator_tpu_torch.admission import AdmissionConfig
from gubernator_tpu_torch.ops.engine import TickEngine
from gubernator_tpu_torch.resilience.clock import ManualClock as TClock
from gubernator_tpu_torch.transport import fastwire as tfw
from tests.helpers import Sim
from tests.test_torch_state import assert_same_snapshot

NOW = 1_700_000_000_000
NOW_S = NOW / 1000


def tup(x):
    return None if x is None else dataclasses.astuple(x)


def both(cls: str, rows):
    """The same objects of lease class ``cls`` in (port, JAX)."""
    return ([None if r is None else getattr(tl, cls)(*r) for r in rows],
            [None if r is None else getattr(jl, cls)(*r) for r in rows])


FRAMES = {
    "grant_req": ("LeaseSpec", [
        ("n1", "k1", 100, 60_000, 1, 5, 25, "client-a"),
        ("n2", "k2", 7, 1_000, 0, 0, 0, ""),
        ("név", "ключ", 1 << 40, 3_600_000, 4, 2, 9, "h")]),
    "grant_resp": ("LeaseToken", [
        ("n1", "k1", 25, 1_700_000_005_000, 2, b"\x01" * 64), None,
        ("n2", "k2", 0, 0, 1 << 31, b"")]),
    "sync_req": ("LeaseSync", [
        ("n1", "k1", 13, 2, True, "client-a"), ("n2", "k2", 0, 1, False, ""),
        ("n3", "k3", -4, 9, False, "z")]),
    "sync_resp": ("LeaseSyncAck", [
        (True, 2, 12, 0), (False, 9, 0, 3), (True, -1, 1 << 40, 7)]),
}


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_lease_frames_encode_alike_and_parse_each_other(frame):
    port, ref = both(*FRAMES[frame])
    tb = getattr(tfw, f"encode_lease_{frame}")(port)
    jb = getattr(jfw, f"encode_lease_{frame}")(ref)
    assert tb == jb
    assert [tup(x) for x in getattr(tfw, f"parse_lease_{frame}")(jb)] == \
        [tup(x) for x in port]
    assert [tup(x) for x in getattr(jfw, f"parse_lease_{frame}")(tb)] == \
        [tup(x) for x in ref]
    assert getattr(tfw, f"parse_lease_{frame}")(tb[:8]) is None or \
        len(port) == 0


def _ps(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<H", len(b)) + b


def test_v1_request_frames_parse_alike():
    grant_v1 = (b"GLR1" + struct.pack("<I", 2)
                + struct.pack("<qqqqq", 5, 1_000, 0, 0, 2) + _ps("n") + _ps("k")
                + struct.pack("<qqqqq", 9, 60_000, 1, 3, 0) + _ps("m")
                + _ps("j"))
    sync_v1 = (b"GSY1" + struct.pack("<I", 2)
               + struct.pack("<qqB", 3, 1, 1) + _ps("n") + _ps("k")
               + struct.pack("<qqB", 0, 7, 0) + _ps("m") + _ps("j"))
    for kind, raw in (("grant_req", grant_v1), ("sync_req", sync_v1)):
        got = getattr(tfw, f"parse_lease_{kind}")(raw)
        want = getattr(jfw, f"parse_lease_{kind}")(raw)
        assert [tup(x) for x in got] == [tup(x) for x in want]
        assert all(x.holder == "" for x in got)


def _malformed(good: bytes, other: bytes):
    n = struct.unpack_from("<I", good, 4)[0]
    return {
        "empty": b"", "magic_only": good[:4], "header_only": good[:8],
        "wrong_magic": b"XXXX" + good[4:], "truncated": good[:-1],
        "trailing": good + b"\x00",
        "count_up": good[:4] + struct.pack("<I", n + 1) + good[8:],
        "count_down": good[:4] + struct.pack("<I", n - 1) + good[8:],
        "other_frame": other, "bad_utf8_tail": good[:-2] + b"\xff\xfe",
    }


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_both_packages_reject_the_same_malformed_frames(frame):
    port, _ = both(*FRAMES[frame])
    good = getattr(tfw, f"encode_lease_{frame}")(port)
    other = tfw.encode_lease_sync_resp([tl.LeaseSyncAck(True, 1)]) \
        if frame != "sync_resp" else tfw.encode_lease_grant_resp([None])
    for name, bad in _malformed(good, other).items():
        got = getattr(tfw, f"parse_lease_{frame}")(bad)
        want = getattr(jfw, f"parse_lease_{frame}")(bad)
        assert (got is None) == (want is None), (frame, name)
        if got is not None:
            assert [tup(x) for x in got] == [tup(x) for x in want]
        if name not in ("bad_utf8_tail",):
            assert got is None, (frame, name)


# ----------------------------------------------------------------------
# Signing
# ----------------------------------------------------------------------
PAYLOADS = [("n", "k", 5, NOW + 5_000, 1), ("ab", "c", 0, 0, 0),
            ("a", "bc", -1, -2, 1 << 40), ("név", "ключ", 1 << 62, 7, 3)]


@pytest.mark.parametrize("fields", PAYLOADS)
def test_payload_and_hmac_tokens_are_byte_equal(fields):
    assert tl.lease_payload(*fields) == jl.lease_payload(*fields)
    ts, js = tl.LeaseSigner(secret=b"s3"), jl.LeaseSigner(secret=b"s3")
    tt, jt = ts.mint(*fields), js.mint(*fields)
    assert tup(tt) == tup(jt)
    assert ts.scheme == js.scheme == "hmac-sha256"
    assert jl.LeaseVerifier("hmac-sha256", b"s3").verify(jt)
    assert tl.LeaseVerifier("hmac-sha256", b"s3").verify(tt)
    bad = dataclasses.replace(tt, budget=tt.budget + 1)
    assert not ts.verify(bad)
    assert not js.verify(jl.LeaseToken(*tup(bad)))


def test_ed25519_tokens_verify_across_packages():
    assert tl.HAVE_CRYPTO == jl.HAVE_CRYPTO
    if not tl.HAVE_CRYPTO:
        pytest.skip("cryptography is not installed")
    ts, js = tl.LeaseSigner(), jl.LeaseSigner()
    assert ts.scheme == js.scheme == "ed25519"
    tv = ts.verifier()
    jv_of_t = jl.LeaseVerifier("ed25519", tv._material)
    tv_of_j = tl.LeaseVerifier("ed25519", js.verifier()._material)
    for fields in PAYLOADS:
        tt, jt = ts.mint(*fields), js.mint(*fields)
        assert jv_of_t.verify(jl.LeaseToken(*tup(tt)))
        assert tv_of_j.verify(tl.LeaseToken(*tup(jt)))
        for tamper in (dict(budget=tt.budget + 1),
                       dict(expires_ms=tt.expires_ms + 1),
                       dict(generation=tt.generation + 1),
                       dict(signature=bytes(64))):
            bt, bj = (dataclasses.replace(tt, **tamper),
                      dataclasses.replace(jt, **tamper))
            assert not tv.verify(bt)
            assert not jv_of_t.verify(jl.LeaseToken(*tup(bt)))
            assert not tv_of_j.verify(tl.LeaseToken(*tup(bj)))
            assert not js.verifier().verify(bj)


def test_force_hmac_and_no_cryptography_take_the_stdlib_path(monkeypatch):
    for pkg in (tl, jl):
        s = pkg.LeaseSigner(force_hmac=True)
        assert s.scheme == "hmac-sha256" and len(s._secret) == 32
        assert s.verify(s.mint("n", "k", 1, 2, 3))
    from gubernator_tpu.leases import signing as jsig
    from gubernator_tpu_torch.leases import signing as tsig

    for mod in (tsig, jsig):
        monkeypatch.setattr(mod, "HAVE_CRYPTO", False)
    a, b = tsig.LeaseSigner(), jsig.LeaseSigner()
    assert a.scheme == b.scheme == "hmac-sha256"
    assert a.verifier().scheme == "hmac-sha256"


# ----------------------------------------------------------------------
# LeaseCache on a ManualClock
# ----------------------------------------------------------------------
def cache_script(L, clock_cls, seed: int, close_in: float):
    """A seeded sequence over one LeaseCache whose grant and sync calls
    go to a scripted owner (it can fail, bump the generation, shrink the
    budget); returns every verdict, sync and stats() on the way."""
    rng = np.random.default_rng(seed)
    clk = clock_cls(start=NOW_S)
    signer = L.LeaseSigner(secret=b"cache")
    owner = {"fail": False, "gen": 1, "budget": 8}

    def grant_fn(specs):
        if owner["fail"]:
            raise RuntimeError("owner unreachable")
        return [signer.mint(s.name, s.key, min(s.want, owner["budget"]),
                            int(clk() * 1000) + 2_000, owner["gen"])
                if owner["budget"] else None for s in specs]

    def sync_fn(syncs):
        if owner["fail"]:
            raise RuntimeError("owner unreachable")
        return [L.LeaseSyncAck(accepted=s.generation == owner["gen"],
                               generation=owner["gen"]) for s in syncs]

    cache = L.LeaseCache(grant_fn, sync_fn, clock=clk,
                         verifier=signer.verifier(), want_budget=5,
                         offline_grace_ms=1_000, max_offline_extensions=2,
                         holder_id="h")
    out = []
    for step in range(300):
        op = int(rng.integers(0, 12))
        spec = L.LeaseSpec("n", "abc"[int(rng.integers(0, 3))],
                           limit=int(rng.choice([100, 100, 50])),
                           duration=60_000)
        if op < 6:
            out.append(("admit", cache.admit(spec, int(rng.integers(1, 4)))))
        elif op == 6:
            out.append(("try", cache.try_admit(spec)))
        elif op == 7:
            clk.advance(float(rng.choice([0.25, 1.5, 3.0])))
        elif op == 8:
            owner["fail"] = not owner["fail"]
        elif op == 9:
            owner["gen"] += int(rng.integers(0, 2))
            owner["budget"] = int(rng.choice([0, 3, 8, 8]))
        else:
            syncs = cache.take_syncs(release=bool(rng.random() < 0.2))
            out.append(("syncs", [tup(s) for s in syncs]))
            if syncs and not owner["fail"]:
                cache.note_synced(syncs, sync_fn(syncs))
        if step % 25 == 0:
            out.append(("stats", dataclasses.asdict(cache.stats())))
    owner["fail"] = False
    out.append(("close", cache.close(deadline=clk() + close_in)))
    out.append(("stats", dataclasses.asdict(cache.stats())))
    out.append(("close_again", cache.close()))
    with pytest.raises(RuntimeError, match="closed"):
        cache.try_admit(L.LeaseSpec("n", "a", 100, 60_000))
    return out


@pytest.mark.parametrize("seed,close_in", [(1, 1.0), (2, -1.0), (3, 5.0)])
def test_lease_cache_verdicts_and_stats_match_jax(seed, close_in):
    got = cache_script(tl, TClock, seed, close_in)
    want = cache_script(jl, JClock, seed, close_in)
    assert got == want
    kinds = {k for k, _ in got}
    assert {"admit", "try", "syncs", "close"} <= kinds
    verdicts = [v for k, v in got if k == "admit"]
    assert True in verdicts and False in verdicts and None in verdicts


def test_offline_extension_under_a_raising_grant_matches_jax():
    outs = []
    for L, clock_cls in ((tl, TClock), (jl, JClock)):
        clk = clock_cls(start=NOW_S)
        signer = L.LeaseSigner(secret=b"x")
        fail = {"on": False}

        def grant_fn(specs):
            if fail["on"]:
                raise ConnectionError("breaker open")
            return [signer.mint(s.name, s.key, 4, int(clk() * 1000) + 1_000,
                                1) for s in specs]

        cache = L.LeaseCache(grant_fn, lambda syncs: [], clock=clk,
                             want_budget=4, offline_grace_ms=500,
                             max_offline_extensions=2, holder_id="h")
        spec = L.LeaseSpec("n", "k", 10, 60_000)
        seq = [cache.admit(spec)]
        fail["on"] = True
        for _ in range(6):
            clk.advance(0.6)
            seq.append(cache.admit(spec))
        seq.append(dataclasses.asdict(cache.stats()))
        seq.append(cache.close(deadline=clk() + 1.0))
        outs.append(seq)
    assert outs[0] == outs[1]
    assert outs[0][-2]["offline_extensions"] == 2


# ----------------------------------------------------------------------
# LeaseManager: chip_smoke's seeded edge-case sequence
# ----------------------------------------------------------------------
def test_lease_manager_sequence_matches_jax():
    sim = Sim()
    want = cs.lease_sequence(jl, jtypes, sim.engine, JClock, sim.now)
    eng = TickEngine(capacity=1024, max_batch=64, device="cpu")
    got = cs.lease_sequence(tl, ttypes, eng, TClock, sim.now)
    assert got == want
    assert_same_snapshot(eng.export_columns(), sim.engine.export_columns())
    # What the sequence reaches.
    stats = got["stats"]
    assert stats["grants"] >= 9 and stats["renewals"] == 1
    assert stats["revocations"] == 2 and stats["sync_loss"] > 0
    assert stats["sync_dropped"] > 0
    acks = [a for call in got["acks"] for a in call]
    assert any(not a[0] for a in acks)          # stale
    assert any(a[2] > 0 for a in acks)          # credited
    assert any(a[3] > 0 for a in acks)          # force-charged
    gens = [t[4] for call in got["grants"] for t in call if t and
            t[1] == "k4"]
    assert gens == sorted(gens) and gens[-1] > gens[0]


def test_lease_config_from_env_matches_jax(monkeypatch):
    from gubernator_tpu_torch import config as tconfig

    knobs = ("GUBER_LEASE_ENABLED", "GUBER_LEASE_TTL",
             "GUBER_LEASE_BUDGET_FRACTION", "GUBER_LEASE_MAX_BUDGET",
             "GUBER_LEASE_CREDIT_BACK", "GUBER_LEASE_SECRET",
             "GUBER_LEASE_OFFLINE_GRACE")
    for k in knobs:
        monkeypatch.delenv(k, raising=False)
    assert dataclasses.asdict(tl.LeaseConfig.from_env()) == \
        dataclasses.asdict(jl.LeaseConfig.from_env())
    for values in (("0", "30s", "0.25", "500", "0", "s3cret", "2s"),
                   ("1", "1m", "bad", "x", "1", "", "")):
        for k, v in zip(knobs, values):
            monkeypatch.setenv(k, v)
        assert dataclasses.asdict(tl.LeaseConfig.from_env()) == \
            dataclasses.asdict(jl.LeaseConfig.from_env())
    # Every lease knob is registered, and a node built with them set no
    # longer raises.
    env = dict(zip(knobs, ("1", "30s", "0.25", "500", "1", "s", "2s")))
    assert all(k in tconfig.ENV_REGISTRY for k in knobs)
    tconfig.reject_unported(env)
    tconfig.setup_daemon_config(environ=env)


def test_revoke_and_release_keep_generations_monotonic_and_columns_zero():
    eng = TickEngine(capacity=64, max_batch=16, device="cpu")
    mgr = tl.LeaseManager(eng, config=tl.LeaseConfig(secret=b"m"),
                          signer=tl.LeaseSigner(secret=b"m"))
    spec = tl.LeaseSpec("r", "k", 100, 60_000, want=10, holder="A")
    gens = []
    for _ in range(3):
        [tok] = mgr.grant_local([spec], now_ms=NOW)
        gens.append(tok.generation)
        mgr.sync_local([tl.LeaseSync("r", "k", 4, tok.generation, True,
                                     "A")], now_ms=NOW)
    assert gens == [1, 2, 3]
    # A released key mirrors no holder: budget and expiry 0, the last
    # generation kept.
    assert [c.tolist() for c in eng.lease_columns([b"r_k"])] == \
        [[0], [0], [3]]
    assert eng.process([ttypes.RateLimitRequest(
        name="r", unique_key="k", hits=0, limit=100,
        duration=60_000)], now=NOW)[0].remaining == 88


# ----------------------------------------------------------------------
# The service
# ----------------------------------------------------------------------
def test_tickloop_under_pressure_as_the_reference():
    from gubernator_tpu_torch.service.tickloop import TickLoop

    class _StubEngine:
        def submit(self, reqs):
            raise AssertionError("no window is submitted")

    loop = TickLoop(_StubEngine(), batch_limit=100,
                    admission=AdmissionConfig(target_p99_ms=5.0))
    try:
        assert not loop.under_pressure()
        for _ in range(loop.limiter.adjust_every):
            loop.limiter.record(50.0)  # saturation: the window narrows
        assert loop.limiter.window_limit < loop.batch_limit
        assert loop.under_pressure()
    finally:
        loop.close()


def _instance_leases(**conf):
    """Grant, consume and release through a CPU V1Instance's tick loop;
    returns (tokens, acks, probes, engine)."""
    from gubernator_tpu_torch.service.instance import (
        InstanceConfig, V1Instance)

    async def run():
        inst = await V1Instance.create(InstanceConfig(
            cache_size=256, tpu_max_batch=64, tpu_platform="cpu", **conf))
        try:
            specs = [tl.LeaseSpec("svc", f"k{i}", 100, 60_000, want=10,
                                  holder=h) for i in range(6) for h in "AB"]
            toks = await inst.lease_grant(specs)
            syncs = [tl.LeaseSync("svc", s.key, 3, t.generation, True,
                                  s.holder) for s, t in zip(specs, toks)]
            acks = await inst.lease_sync(syncs)
            probes = await inst.get_rate_limits([ttypes.RateLimitRequest(
                name="svc", unique_key=f"k{i}", hits=0, limit=100,
                duration=60_000) for i in range(6)])
            return toks, acks, probes, inst.engine, inst.lease_mgr.stats()
        finally:
            await inst.close()

    return asyncio.run(run())


@pytest.mark.parametrize("shards", [0, 2])
def test_instance_grants_and_syncs_through_its_tick_loop(shards):
    toks, acks, probes, eng, stats = _instance_leases(tpu_mesh_shards=shards)
    assert [t.budget for t in toks] == [10] * 12
    assert all(a.accepted and a.credited == 7 for a in acks)
    assert [r.remaining for r in probes] == [94] * 6
    assert stats["held"] == 0 and stats["outstanding_total"] == 0
    if shards:
        # The mesh engine has no lease columns: nothing is mirrored.
        assert not hasattr(eng, "lease_window")
    else:
        assert eng.metric_lease_windows == 2
        assert eng.metric_lease_dispatches == 2
