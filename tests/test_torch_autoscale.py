"""The port's shard autoscaler against the JAX package's.

* Each controller scenario of ``tests/test_autoscale.py`` runs on both
  packages with the same ``SignalSnapshot`` sequences, the same scripted
  reshard executor and a ``ManualClock``: equal decision rings (every
  entry's ``as_dict()``), equal ``debug_state()``, equal executor calls
  and equal counter samples.
* ``instance_sampler`` over a port ``V1Instance`` and a JAX one, each
  with a flight recorder that saw the same windows: equal snapshots.
* ``GET /debug/autoscaler`` and the ``autoscaler`` entry of
  ``/debug/state`` of a port daemon against a JAX daemon's, both
  controllers stepped on the same scripted samples.
* The compressed diurnal day (the reference's ``diurnal_autoscale``
  rung at its CPU size: 1024 keys on an 8 x 2^9 mesh, live reshards
  under load) on the port only, meeting the rung's gates.
"""

import asyncio
import json
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as cs


def pkg(which: str) -> SimpleNamespace:
    if which == "jax":
        from gubernator_tpu import autoscale, config
        from gubernator_tpu.autoscale import controller, policy
        from gubernator_tpu.resilience import ManualClock
        from gubernator_tpu.utils.metrics import Metrics
    else:
        from gubernator_tpu_torch import autoscale, config
        from gubernator_tpu_torch.autoscale import controller, policy
        from gubernator_tpu_torch.resilience import ManualClock
        from gubernator_tpu_torch.utils.metrics import Metrics
    return SimpleNamespace(autoscale=autoscale, controller=controller,
                           policy=policy, config=config,
                           ManualClock=ManualClock, Metrics=Metrics)


def snap(P, p99=1.0, queue=0, occ=0.5, shards=2, **kw):
    return P.autoscale.SignalSnapshot(
        p99_ms=p99, queue_depth=queue, hot_occupancy=occ, shards=shards,
        **kw)


class Feed:
    """Scripted sampler: pops queued snapshots, repeats the last one."""

    def __init__(self, *snaps):
        self.snaps = list(snaps)

    def script(self, *snaps):
        self.snaps = list(snaps)

    def __call__(self):
        if len(self.snaps) > 1:
            return self.snaps.pop(0)
        return self.snaps[0]


class FakeReshard:
    """Executor double: records targets, scripts outcomes."""

    def __init__(self, outcome="committed"):
        self.calls, self.outcome = [], outcome

    def __call__(self, target):
        self.calls.append(target)
        if self.outcome == "busy":
            return {"result": "busy"}
        if self.outcome == "raise":
            raise RuntimeError("engine exploded")
        return {"outcome": self.outcome, "from_shards": 0,
                "to_shards": target}


class Run:
    """One scenario's controller on one package, with everything the
    comparison reads."""

    def __init__(self, P, feed, reshard, *, windows=3, dry_run=False,
                 **kw):
        self.P, self.feed, self.reshard = P, feed, reshard
        self.clock = P.ManualClock()
        self.metrics = P.Metrics()
        self.scaler = P.autoscale.Autoscaler(
            feed, reshard, policy=P.autoscale.AutoscalePolicy(
                P.autoscale.PolicyConfig(
                    windows=windows, target_p99_ms=5.0, queue_high=100,
                    hysteresis=0.5, occupancy_low=0.3, min_shards=1,
                    max_shards=8)),
            dry_run=dry_run, clock=self.clock, sleep=self.clock.sleep,
            metrics=self.metrics, **kw)

    async def steps(self, n, dt=10.0):
        out = []
        for _ in range(n):
            self.clock.advance(dt)
            out.append(await self.scaler.step())
        return out

    def result(self):
        m = self.metrics
        counters = {}
        for fam, label, values in (
                ("decisions", "action", ("act", "hold", "veto")),
                ("transitions", "direction", ("up", "down")),
                ("vetoes", "reason", ("breaker_open", "reshard_busy",
                                      "cooldown_up", "cooldown_down",
                                      "flap_cap", "reshard_error"))):
            for v in values:
                counters[f"{fam}:{v}"] = m.sample(
                    f"gubernator_tpu_autoscale_{fam}_total", {label: v})
        return {"ring": [d.as_dict() for d in self.scaler.ring],
                "state": self.scaler.debug_state(),
                "calls": list(self.reshard.calls), "counters": counters}


async def sc_single_spike_holds_sustained_pressure_acts(P):
    feed = Feed(snap(P, p99=50.0), snap(P), snap(P))
    r = Run(P, feed, FakeReshard())
    d = await r.steps(3)
    assert [x.action for x in d] == ["hold"] * 3
    feed.script(snap(P, p99=50.0))
    d = await r.steps(3)
    assert [x.action for x in d] == ["hold", "hold", "act"]
    assert r.reshard.calls == [4]
    return r.result()


async def sc_queue_depth_alone_triggers_scale_up(P):
    r = Run(P, Feed(snap(P, queue=500)), FakeReshard(), windows=2)
    d = await r.steps(2)
    assert d[-1].action == "act" and d[-1].direction == "up"
    return r.result()


async def sc_hysteresis_band_prevents_ping_pong(P):
    feed = Feed(snap(P, p99=50.0))
    r = Run(P, feed, FakeReshard(), windows=2, cooldown_up=0.0,
            cooldown_down=0.0)
    await r.steps(2)
    feed.script(snap(P, p99=4.0, occ=0.05, shards=4))
    d = await r.steps(20)
    assert all(x.action == "hold" for x in d)
    feed.script(snap(P, p99=1.0, occ=0.05, shards=4))
    d = await r.steps(2)
    assert d[-1].action == "act" and d[-1].direction == "down"
    assert r.reshard.calls == [4, 2]
    return r.result()


async def sc_cooldown_vetoes_counted_then_expire(P):
    r = Run(P, Feed(snap(P, p99=50.0)), FakeReshard(), windows=1,
            cooldown_up=120.0)
    await r.steps(1)
    d = await r.steps(3)
    assert [x.reason for x in d] == ["cooldown_up"] * 3
    r.clock.advance(120.0)
    d = await r.steps(1)
    assert d[0].action == "act" and r.reshard.calls == [4, 4]
    return r.result()


async def sc_flap_cap_bounds_transitions_per_rolling_hour(P):
    r = Run(P, Feed(snap(P, p99=50.0)), FakeReshard(), windows=1,
            cooldown_up=0.0, max_per_hour=2)
    d = await r.steps(5)
    assert [x.action for x in d].count("act") == 2
    r.clock.advance(3600.0)
    d = await r.steps(1)
    assert d[0].action == "act" and len(r.reshard.calls) == 3
    return r.result()


async def sc_open_breaker_vetoes_actuation(P):
    r = Run(P, Feed(snap(P, p99=50.0, breaker_open=True)), FakeReshard(),
            windows=1)
    d = await r.steps(3)
    assert all(x.reason == "breaker_open" for x in d)
    return r.result()


async def sc_reshard_busy_before_the_call(P):
    r = Run(P, Feed(snap(P, p99=50.0, reshard_busy=True)), FakeReshard(),
            windows=1)
    (d,) = await r.steps(1)
    assert d.reason == "reshard_busy" and r.reshard.calls == []
    return r.result()


async def sc_reshard_busy_after_the_call(P):
    r = Run(P, Feed(snap(P, p99=50.0)), FakeReshard("busy"), windows=1)
    (d,) = await r.steps(1)
    assert d.reason == "reshard_busy" and r.reshard.calls == [4]
    return r.result()


async def sc_dry_run_records_act_but_never_actuates(P):
    r = Run(P, Feed(snap(P, p99=50.0)), FakeReshard(), windows=1,
            dry_run=True)
    d = await r.steps(5)
    assert all(x.action == "act" and x.outcome == "dry_run" for x in d)
    assert r.reshard.calls == [] and r.scaler.transitions_last_hour() == 0
    return r.result()


async def sc_executor_failure_is_a_veto_not_a_dead_loop(P):
    r = Run(P, Feed(snap(P, p99=50.0)), FakeReshard("raise"), windows=1)
    (d,) = await r.steps(1)
    assert d.reason == "reshard_error"
    return r.result()


async def sc_aborted_transition_charges_the_cooldown(P):
    r = Run(P, Feed(snap(P, p99=50.0)), FakeReshard("aborted"), windows=1,
            cooldown_up=30.0)
    d = await r.steps(4)
    assert [x.reason for x in d] == ["policy", "cooldown_up",
                                     "cooldown_up", "policy"]
    return r.result()


async def sc_frozen_sample_is_skipped_not_counted_as_pressure(P):
    r = Run(P, Feed(snap(P, p99=50.0, frozen=True)), FakeReshard(),
            windows=2)
    d = await r.steps(10)
    assert all(x.action == "hold" for x in d)
    return r.result()


async def sc_at_bound_holds_instead_of_acting(P):
    r = Run(P, Feed(snap(P, p99=50.0, shards=8)), FakeReshard(), windows=1)
    (d,) = await r.steps(1)
    assert d.reason == "at_bound"
    return r.result()


async def sc_decision_ring_wraps_bounded(P):
    r = Run(P, Feed(snap(P)), FakeReshard(), windows=3, ring_size=8)
    await r.steps(50)
    assert len(r.scaler.ring) == 8
    return r.result()


async def sc_mixed_day(P):
    """A seeded stream of samples over every signal and guardrail."""
    rng = np.random.default_rng(7)
    samples = [snap(P, p99=float(rng.choice([0.5, 2.0, 4.0, 9.0, 60.0])),
                    queue=int(rng.choice([0, 50, 150, 900])),
                    occ=float(rng.choice([0.05, 0.2, 0.5, 0.9])),
                    shards=int(rng.choice([1, 2, 4, 8])),
                    breaker_open=bool(rng.random() < 0.1),
                    reshard_busy=bool(rng.random() < 0.1),
                    frozen=bool(rng.random() < 0.1))
               for _ in range(120)]
    r = Run(P, Feed(*samples), FakeReshard(), windows=2, cooldown_up=20.0,
            cooldown_down=60.0, max_per_hour=5, ring_size=64)
    await r.steps(120, dt=7.5)
    return r.result()


SCENARIOS = [
    sc_single_spike_holds_sustained_pressure_acts,
    sc_queue_depth_alone_triggers_scale_up,
    sc_hysteresis_band_prevents_ping_pong,
    sc_cooldown_vetoes_counted_then_expire,
    sc_flap_cap_bounds_transitions_per_rolling_hour,
    sc_open_breaker_vetoes_actuation,
    sc_reshard_busy_before_the_call,
    sc_reshard_busy_after_the_call,
    sc_dry_run_records_act_but_never_actuates,
    sc_executor_failure_is_a_veto_not_a_dead_loop,
    sc_aborted_transition_charges_the_cooldown,
    sc_frozen_sample_is_skipped_not_counted_as_pressure,
    sc_at_bound_holds_instead_of_acting,
    sc_decision_ring_wraps_bounded,
    sc_mixed_day,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
def test_controller_scenario_matches_jax(scenario):
    want = asyncio.run(scenario(pkg("jax")))
    got = asyncio.run(scenario(pkg("port")))
    assert got == want


def test_supervised_loop_runs_on_injected_clock():
    """start() / stop() with the ManualClock's sleep: each turn is one
    interval sleep and one step, in both packages alike."""

    async def run(P):
        rs = FakeReshard()
        clock = P.ManualClock()

        async def vsleep(dt):
            await clock.sleep(dt)
            await asyncio.sleep(0)

        scaler = P.autoscale.Autoscaler(
            Feed(snap(P, p99=50.0)), rs,
            policy=P.autoscale.AutoscalePolicy(
                P.autoscale.PolicyConfig(windows=1, target_p99_ms=5.0)),
            dry_run=False, interval=10.0, clock=clock, sleep=vsleep)
        scaler.start()
        for _ in range(40):
            if rs.calls:
                break
            await asyncio.sleep(0)
        await scaler.stop()
        return rs.calls[:1], sorted(set(clock.sleeps)), scaler._task

    got = asyncio.run(run(pkg("port")))
    assert got == asyncio.run(run(pkg("jax")))
    assert got == ([4], [10.0], None)


@pytest.mark.parametrize("current,direction", [
    (1, "up"), (2, "up"), (8, "up"), (5, "up"), (4, "down"), (2, "down"),
    (1, "down"), (3, "down")])
def test_policy_target_shards_matches_jax(current, direction):
    outs = [pkg(w).autoscale.AutoscalePolicy(pkg(w).autoscale.PolicyConfig(
        min_shards=2, max_shards=8)).target_shards(current, direction)
        for w in ("jax", "port")]
    assert outs[0] == outs[1]


AUTOSCALE_KNOBS = [
    {"GUBER_AUTOSCALE_HYSTERESIS": "1.0"},
    {"GUBER_AUTOSCALE_HYSTERESIS": "0"},
    {"GUBER_AUTOSCALE_MIN_SHARDS": "4", "GUBER_AUTOSCALE_MAX_SHARDS": "2"},
    {"GUBER_AUTOSCALE_MIN_SHARDS": "0"},
    {"GUBER_AUTOSCALE_INTERVAL": "0"},
    {"GUBER_AUTOSCALE_WINDOWS": "0"},
    {"GUBER_AUTOSCALE_TARGET_P99_MS": "-1"},
    {"GUBER_AUTOSCALE_QUEUE_HIGH": "0"},
    {"GUBER_AUTOSCALE_OCCUPANCY_LOW": "1.5"},
    {"GUBER_AUTOSCALE_COOLDOWN_DOWN": "-1s"},
    {"GUBER_AUTOSCALE_MAX_PER_HOUR": "0"},
    {"GUBER_AUTOSCALE_ENABLED": "1", "GUBER_AUTOSCALE_DRY_RUN": "0",
     "GUBER_AUTOSCALE_INTERVAL": "200ms", "GUBER_AUTOSCALE_WINDOWS": "2",
     "GUBER_AUTOSCALE_TARGET_P99_MS": "0", "GUBER_AUTOSCALE_QUEUE_HIGH": "9",
     "GUBER_AUTOSCALE_HYSTERESIS": "0.25",
     "GUBER_AUTOSCALE_OCCUPANCY_LOW": "0",
     "GUBER_AUTOSCALE_MIN_SHARDS": "2", "GUBER_AUTOSCALE_MAX_SHARDS": "16",
     "GUBER_AUTOSCALE_COOLDOWN_UP": "1m",
     "GUBER_AUTOSCALE_COOLDOWN_DOWN": "0",
     "GUBER_AUTOSCALE_MAX_PER_HOUR": "12"},
    {},
]


@pytest.mark.parametrize("env", AUTOSCALE_KNOBS,
                         ids=[str(i) for i in range(len(AUTOSCALE_KNOBS))])
def test_autoscale_knobs_validate_as_jax(env):
    outs = []
    for which in ("jax", "port"):
        try:
            c = pkg(which).config.setup_daemon_config(environ=env).config
            outs.append(("ok", {k: v for k, v in vars(c).items()
                                if k.startswith("autoscale_")}))
        except ValueError as e:
            outs.append(("error", str(e)))
    assert outs[0] == outs[1]
    assert len(outs[1][1]) == 13 or outs[1][0] == "error"


# ----------------------------------------------------------------------
# The sampler and the daemon's endpoints
# ----------------------------------------------------------------------
def record_windows(rec, n=24):
    """The same window records in either package's flight recorder."""
    rng = np.random.default_rng(3)
    for _ in range(n):
        w = rec.begin(int(rng.integers(1, 64)), int(rng.integers(0, 9)))
        for stage in ("pack", "h2d", "tick", "resolve"):
            if rng.random() < 0.9:
                rec.note(w, stage, float(rng.integers(1, 5000)) * 1e-6)
        rec.finish(w)


async def test_instance_sampler_matches_the_jax_instance():
    from gubernator_tpu.service.instance import (
        InstanceConfig as JConfig, V1Instance as JInstance)
    from gubernator_tpu.utils import flightrec as jfr
    from gubernator_tpu_torch.autoscale import instance_sampler
    from gubernator_tpu.autoscale import instance_sampler as jsampler
    from gubernator_tpu_torch.service.instance import (
        InstanceConfig, V1Instance)
    from gubernator_tpu_torch.utils import flightrec as tfr

    ji = await JInstance.create(JConfig(cache_size=256))
    ti = await V1Instance.create(InstanceConfig(cache_size=256,
                                                tpu_platform="cpu"))
    try:
        outs = []
        for inst, sampler, fr in ((ji, jsampler, jfr), (ti, instance_sampler,
                                                        tfr)):
            before = vars(sampler(inst, lambda: 12.5)())
            rec = fr.FlightRecorder(windows=16)
            record_windows(rec)
            fr.install(rec)
            try:
                after = vars(sampler(inst, lambda: 12.5)())
            finally:
                fr.uninstall()
            outs.append((before, after))
        assert outs[1] == outs[0]
        before, after = outs[1]
        assert before["p99_ms"] == 0.0 and after["p99_ms"] > 0
        assert after["shards"] == 1 and not after["frozen"]
        assert set(after["stage_p99_ms"]) == set(tfr.STAGES)
    finally:
        await ti.close()
        await ji.close()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


async def endpoint_bodies(d, P, samples):
    """Step daemon ``d``'s controller (its loop stopped) on ``samples``
    under a ManualClock and read /debug/autoscaler and /debug/state."""
    scaler = d.instance.autoscaler
    await scaler.stop()
    clock = P.ManualClock(1000.0)
    scaler._clock, scaler.sample = clock, Feed(*samples)
    for _ in range(len(samples)):
        clock.advance(10.0)
        await scaler.step()
    url = f"http://{d.conf.http_listen_address}"
    st, body = await asyncio.to_thread(_get, url + "/debug/autoscaler")
    _, state = await asyncio.to_thread(_get, url + "/debug/state")
    return st, body, state["autoscaler"]


async def test_debug_autoscaler_answers_as_the_jax_daemon(monkeypatch):
    from gubernator_tpu import config as jconfig
    from gubernator_tpu.ops.engine import TickEngine as JaxEngine
    from gubernator_tpu.transport import daemon as jdaemon
    from gubernator_tpu_torch import config
    from gubernator_tpu_torch.transport import daemon

    monkeypatch.setenv("GUBER_DEBUG_ENDPOINTS", "1")
    knobs = dict(autoscale_enabled=True, autoscale_interval=3600.0,
                 autoscale_windows=2, autoscale_min_shards=1,
                 autoscale_max_shards=4, autoscale_queue_high=100)
    jd = await jdaemon.spawn_daemon(jconfig.DaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
        config=jconfig.Config(cache_size=1024, tpu_max_batch=64, **knobs)),
        engine=JaxEngine(capacity=1024, max_batch=64))
    td = await daemon.spawn_daemon(config.DaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
        config=config.Config(cache_size=1024, tpu_max_batch=64,
                             tpu_platform="cpu", **knobs)))
    off = await daemon.spawn_daemon(config.DaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
        config=config.Config(cache_size=64, tpu_max_batch=16,
                             tpu_platform="cpu")))
    try:
        outs = []
        for d, w in ((jd, "jax"), (td, "port")):
            P = pkg(w)
            samples = [snap(P, p99=60.0, shards=1), snap(P, queue=500,
                                                         shards=1),
                       snap(P, p99=0.5, occ=0.1, shards=2),
                       snap(P, p99=0.5, occ=0.1, shards=2)]
            outs.append(await endpoint_bodies(d, P, samples))
        assert outs[1] == outs[0]
        st, body, state = outs[1]
        assert st == 200 and body["dry_run"] is True
        assert [x["action"] for x in body["decisions"]] == [
            "hold", "act", "hold", "act"]
        assert "decisions" not in state and state["last_decision"] == \
            body["decisions"][-1]
        assert td.metrics.sample("gubernator_tpu_autoscale_decisions_total",
                                 {"action": "act"}) == 2
        url = f"http://{off.conf.http_listen_address}"
        st, body = await asyncio.to_thread(_get, url + "/debug/autoscaler")
        assert st == 404 and "GUBER_AUTOSCALE_ENABLED" in body["error"]
        _, state = await asyncio.to_thread(_get, url + "/debug/state")
        assert "autoscaler" not in state
    finally:
        await off.close()
        await td.close()
        await jd.close()


# ----------------------------------------------------------------------
# The compressed day on the port (the diurnal_autoscale rung, CPU size)
# ----------------------------------------------------------------------
def test_diurnal_day_meets_the_rungs_gates():
    """1024 keys on an 8 x 2^9 CPU mesh behind a tick loop, a load thread
    sending 256-wide windows, the rung's 96 control windows: at least two
    committed autonomous transitions, no state lost, no flap, the day
    saving shard-seconds against a static 8 shards."""
    import torch

    out = cs.autoscale_day(torch, torch.device("cpu"), keys=1 << 10,
                           n_shards=8, local_capacity=1 << 9, width=256,
                           serve_s=0.0)
    assert out["autoscale_transitions"] >= 2, out
    assert out["autoscale_state_loss"] == 0 and out["autoscale_flaps"] == 0
    assert out["parity_errors"] == 0 and out["chip_seconds_saved"] > 0
    assert out["shards_path"].startswith("8->4")
