"""The port's admission plane and tick loop against the JAX package's.

``AdmissionQueue``, ``AimdLimiter`` and the deadline helpers of both
packages take the same operations on a manual clock and must make the
same decisions; the port's ``TickLoop`` sheds, degrades and closes as the
JAX package's does over stub engines, and over a ``device="cpu"`` port
engine answers exactly what the engine answers when called directly.
"""

import threading
import time

import numpy as np
import pytest

from gubernator_tpu import admission as jadm
from gubernator_tpu.resilience.clock import ManualClock
from gubernator_tpu_torch import admission as adm
from gubernator_tpu_torch.ops.engine import TickEngine
from gubernator_tpu_torch.ops.reqcols import ReqColumns
from gubernator_tpu_torch.service.tickloop import TickLoop
from gubernator_tpu_torch.types import (
    RateLimitRequest, RateLimitResponse, Status)

NOW = 1_700_000_000_000


@pytest.mark.parametrize("seed", range(8))
def test_admission_queue_makes_the_jax_decisions(seed):
    """Random pushes (two classes, deadlines or none, sizes 1-40) and
    window pops: the same items are shed and popped, in the same order."""
    rng = np.random.default_rng(seed)
    qj, qp = jadm.AdmissionQueue(64), adm.AdmissionQueue(64)
    for step in range(200):
        if rng.random() < 0.7:
            n = int(rng.integers(1, 41))
            klass = int(rng.integers(0, 2))
            deadline = (None if rng.random() < 0.3
                        else float(rng.integers(0, 1000)))
            sj = qj.push(jadm.QueueItem("obj", step, n, None, deadline, klass))
            sp = qp.push(adm.QueueItem("obj", step, n, None, deadline, klass))
            assert [i.payload for i in sj] == [i.payload for i in sp]
        else:
            width = int(rng.integers(1, 80))
            pj, pp = qj.pop_window(width), qp.pop_window(width)
            assert [i.payload for i in pj] == [i.payload for i in pp]
        assert qj.requests == qp.requests and len(qj) == len(qp)
        assert qj.snapshot() == qp.snapshot()
    assert ([i.payload for i in qj.drain()]
            == [i.payload for i in qp.drain()])


@pytest.mark.parametrize("seed", range(4))
def test_aimd_limiter_follows_the_jax_limiter(seed):
    rng = np.random.default_rng(10 + seed)
    lj = jadm.AimdLimiter(5.0, max_limit=4096)
    lp = adm.AimdLimiter(5.0, max_limit=4096)
    for _ in range(600):
        ms = float(rng.choice([1.0, 4.0, 6.0, 40.0]))
        lj.record(ms)
        lp.record(ms)
        assert lj.window_limit == lp.window_limit
    assert lj.snapshot() == lp.snapshot()
    off_j, off_p = jadm.AimdLimiter(0, 100), adm.AimdLimiter(0, 100)
    off_j.record(1e9)
    off_p.record(1e9)
    assert not off_p.enabled and off_p.window_limit == off_j.window_limit


def test_deadline_helpers_match_on_a_manual_clock():
    clk = ManualClock(start=50.0)
    for value in (None, "0", "1500", "-3", "junk", "12.5"):
        assert (adm.deadline_from_header(value, clk())
                == jadm.deadline_from_header(value, clk()))
    for d in (None, 49.0, 50.0, 51.25):
        assert (adm.budget_header_value(d, clk())
                == jadm.budget_header_value(d, clk()))
        assert (adm.remaining_budget(d, clk())
                == jadm.remaining_budget(d, clk()))
    reqs = [RateLimitRequest(deadline=d) for d in (None, 70.0, 60.0)]
    assert adm.batch_deadline(reqs) == jadm.batch_deadline(reqs) == 60.0
    item = adm.QueueItem("obj", [], 1, None, deadline=60.0)
    clk.advance(10.0)
    assert item.expired(clk())
    assert adm.DEADLINE_METADATA_KEY == jadm.DEADLINE_METADATA_KEY


@pytest.mark.parametrize("env", [
    {},
    {"GUBER_REQUEST_TIMEOUT": "250ms", "GUBER_TARGET_P99_MS": "2.5",
     "GUBER_PENDING_LIMIT": "77", "GUBER_SHED_POLICY": "fail-closed"},
    {"GUBER_REQUEST_TIMEOUT": "junk", "GUBER_TARGET_P99_MS": "x",
     "GUBER_PENDING_LIMIT": "y", "GUBER_SHED_POLICY": "bogus"},
])
def test_admission_config_from_env_matches(monkeypatch, env):
    for k in ("GUBER_REQUEST_TIMEOUT", "GUBER_TARGET_P99_MS",
              "GUBER_PENDING_LIMIT", "GUBER_SHED_POLICY"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    a, b = jadm.AdmissionConfig.from_env(), adm.AdmissionConfig.from_env()
    assert vars(a) == vars(b)
    assert a.effective_pending_limit(300) == b.effective_pending_limit(300)


# ----------------------------------------------------------------------
# The tick loop over stub engines (deadline math on a manual clock)
# ----------------------------------------------------------------------
class _StubBatch:
    def __init__(self, reqs):
        self._reqs = reqs

    def handles(self):
        return []

    def responses(self):
        return [RateLimitResponse(status=Status.UNDER_LIMIT, limit=r.limit,
                                  remaining=r.limit - r.hits)
                for r in self._reqs]


class _StubEngine:
    """Counts submissions; optionally blocks inside submit."""

    def __init__(self, gate: threading.Event = None):
        self.batches = []
        self.gate = gate
        self.entered = threading.Event()

    def submit(self, reqs):
        self.entered.set()
        if self.gate is not None:
            self.gate.wait(timeout=30)
        self.batches.append(list(reqs))
        return _StubBatch(reqs)


def _reqs(n, limit=100):
    return [RateLimitRequest(name="t", unique_key=str(i), hits=1, limit=limit,
                             duration=60_000, created_at=1_000)
            for i in range(n)]


def test_tickloop_sheds_expired_before_pack_and_serves_the_live():
    clk = ManualClock(start=100.0)
    eng = _StubEngine()
    loop = TickLoop(eng, admission=adm.AdmissionConfig(), clock=clk)
    try:
        dead = loop.submit(_reqs(2), deadline=50.0)
        live = loop.submit(_reqs(1), deadline=200.0)
        never = loop.submit(_reqs(1))
        assert ([r.error for r in dead.result(timeout=30)]
                == [adm.SHED_EXPIRED_MSG] * 2)
        assert live.result(timeout=30)[0].error == ""
        assert never.result(timeout=30)[0].error == ""
        assert sum(len(b) for b in eng.batches) == 2
        assert loop.metric_shed_admission == {"expired": 2}
        assert loop.metric_expired_served == 0
    finally:
        loop.close()


@pytest.mark.parametrize("policy", [jadm.POLICY_FAIL_OPEN,
                                    jadm.POLICY_FAIL_CLOSED])
def test_tickloop_overflow_answers_the_shed_policy(policy):
    gate = threading.Event()
    eng = _StubEngine(gate=gate)
    loop = TickLoop(eng, admission=adm.AdmissionConfig(
        pending_limit=2, shed_policy=policy))
    try:
        first = loop.submit(_reqs(1))
        assert eng.entered.wait(timeout=30)
        victim = loop.submit(_reqs(2), deadline=time.monotonic() + 50.0)
        survivor = loop.submit(_reqs(2), deadline=time.monotonic() + 500.0)
        out = victim.result(timeout=30)
        gate.set()
        assert survivor.result(timeout=30) and first.result(timeout=30)
        assert loop.metric_shed_admission["overflow"] == 2
        closed = policy == jadm.POLICY_FAIL_CLOSED
        want = Status.OVER_LIMIT if closed else Status.UNDER_LIMIT
        assert all(r.status == want and r.limit == 100 for r in out)
        assert all(r.remaining == (0 if closed else 100) for r in out)
    finally:
        gate.set()
        loop.close()


def test_tickloop_wedged_close_answers_queued_with_retriable_shed():
    gate = threading.Event()
    eng = _StubEngine(gate=gate)
    loop = TickLoop(eng, admission=adm.AdmissionConfig(pending_limit=100))
    first = loop.submit(_reqs(1))
    assert eng.entered.wait(timeout=30)
    stuck = loop.submit(_reqs(3))
    real_join = loop._thread.join
    loop._thread.join = lambda timeout=None: None
    loop.close()
    try:
        assert ([r.error for r in stuck.result(timeout=30)]
                == [adm.SHED_SHUTDOWN_MSG] * 3)
        assert loop.metric_shed_admission["shutdown"] == 3
    finally:
        gate.set()
        loop._thread.join = real_join
        loop._thread.join(timeout=30)
    assert first.result(timeout=30)


def test_tickloop_policy_matrix_matches_the_jax_loop():
    from gubernator_tpu.service.tickloop import TickLoop as JTickLoop

    cols = ReqColumns.from_requests(_reqs(3, limit=7))
    for policy in (jadm.POLICY_FAIL_OPEN, jadm.POLICY_FAIL_CLOSED):
        jl = JTickLoop(_StubEngine(), admission=jadm.AdmissionConfig(
            shed_policy=policy))
        pl = TickLoop(_StubEngine(), admission=adm.AdmissionConfig(
            shed_policy=policy))
        try:
            np.testing.assert_array_equal(jl._policy_matrix(cols, 3),
                                          pl._policy_matrix(cols, 3))
            r = _reqs(1)[0]
            assert vars(jl._policy_response(r)) == vars(pl._policy_response(r))
        finally:
            jl.close()
            pl.close()


def test_tickloop_limiter_narrows_the_admitted_window():
    loop = TickLoop(_StubEngine(), batch_limit=100,
                    admission=adm.AdmissionConfig(target_p99_ms=5.0),
                    clock=ManualClock(start=0.0))
    try:
        for _ in range(loop.limiter.adjust_every):
            loop.limiter.record(50.0)
        assert loop.limiter.window_limit == 80
        assert len(loop.submit(_reqs(5)).result(timeout=30)) == 5
    finally:
        loop.close()


# ----------------------------------------------------------------------
# The tick loop over the port's CPU engine
# ----------------------------------------------------------------------
def _mixed(rng, n, keys=12):
    return [RateLimitRequest(
        name="tl", unique_key=f"k{int(rng.integers(0, keys))}",
        hits=int(rng.integers(0, 4)), limit=int(rng.integers(1, 20)),
        duration=60_000, algorithm=int(rng.integers(0, 5)),
        created_at=NOW + i) for i in range(n)]


@pytest.mark.parametrize("seed", range(3))
def test_tickloop_answers_what_the_engine_answers(seed, monkeypatch):
    """Serial submissions through a TickLoop over one CPU engine, and the
    same batches straight into a second engine, at the same ``now``."""
    from gubernator_tpu_torch.utils import timeutil

    monkeypatch.setattr(timeutil, "now_ms", lambda: NOW)
    rng = np.random.default_rng(20 + seed)
    batches = [_mixed(rng, int(rng.integers(1, 40))) for _ in range(12)]
    direct = TickEngine(capacity=256, max_batch=32, device="cpu")
    looped = TickEngine(capacity=256, max_batch=32, device="cpu")
    loop = TickLoop(looped, batch_limit=32,
                    admission=adm.AdmissionConfig())
    try:
        for k, reqs in enumerate(batches):
            want = direct.process(reqs, now=NOW)
            if k % 2:
                got = loop.submit(reqs).result(timeout=30)
                assert [vars(r) for r in got] == [vars(r) for r in want]
            else:
                mat, errs = loop.submit_columns(
                    ReqColumns.from_requests(reqs)).result(timeout=30)
                assert [(r.status, r.limit, r.remaining, r.reset_time)
                        for r in want] == [tuple(c) for c in mat[:4].T]
                assert errs == {}
    finally:
        loop.close()
    # Serial calls: only a batch's later max_batch chunks are uploaded
    # while an earlier window of it is unresolved.
    chunks = [-(-len(reqs) // 32) for reqs in batches]
    assert looped.metric_h2d_windows == sum(chunks)
    assert looped.metric_h2d_overlapped == sum(c - 1 for c in chunks)
