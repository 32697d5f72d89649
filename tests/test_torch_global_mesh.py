"""The port's GLOBAL mesh (``parallel/global_mesh.py``, ``ops/globalmesh.py``)
against the JAX package's ``MeshGlobalEngine`` on a 4-device CPU mesh.

Both engines take the same windows of the same requests at the same
``now``.  After every process and reconcile step the responses, every
logical field of every replica (``state_fields()`` against the reference
test's ``_full_state``), ``aux``, ``accum``, the slot maps and the step
counters must be equal: integers exactly, float64 words by value.  The
JAX engines are module fixtures at shapes ``tests/test_global_mesh.py``
builds (4 nodes; capacity, max_batch, sparse_k = 64, 32, 0 / 256, 32, 32
/ 256, 64, 4 / 256, 64, 8), plus the non-strict dense step at 64, 32, 0.

Covered: the reference's scenarios (``test_global_mesh.py:48-161``), its
``_drive`` sequence (seed 7), the overflow case, the fused-step fuzz
windows (seed 3, K 8) with the overflow verdict held against the host
recomputation of ``:411-423``, all five algorithms, negative hits, a
window whose repeats take the chained tick (B.5) on ROADMAP C.2's corner
values, reclaim and eviction on a 64-slot table fed more than 64 keys, the
non-strict dense step, and ``import_reference_state`` from mid-run JAX
state followed by a dense and a sparse step.  The plain versions of
B.8b-B.8d run on buffers carried across from the JAX engine and are held
against its step; B.8a is held through the engine's process step on
imported buffers.  The kernels' slot code compiled for the host
(``csrc/global_mesh_host.cc``) is held against the plain versions on
random buffers.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 9).
"""

import ctypes

import numpy as np
import pytest
import torch

from gubernator_tpu.ops.buckets import np_logical, slice_field
from gubernator_tpu.parallel.global_mesh import (
    MeshGlobalEngine as JaxGlobal, make_global_mesh)
from gubernator_tpu.types import RateLimitRequest as JReq
from gubernator_tpu_torch import _build
from gubernator_tpu_torch.ops import globalmesh as gm
from gubernator_tpu_torch.ops.buckets import STATE_FIELDS, logical_to_rows
from gubernator_tpu_torch.ops.reqcols import pack_blob
from gubernator_tpu_torch.ops.sortedtick import fused_sorted_tick_plain
from gubernator_tpu_torch.parallel.global_mesh import (
    MeshGlobalEngine, import_reference_state)
from gubernator_tpu_torch.types import (
    Algorithm, Behavior, PeerInfo, RateLimitRequest)

NOW = 1_700_000_000_000
N = 4
GLOBAL = int(Behavior.GLOBAL)
RESET = int(Behavior.RESET_REMAINING)
LEAKY = int(Algorithm.LEAKY_BUCKET)
COUNTERS = ("metric_reconciles", "metric_reconcile_dispatches",
            "metric_dense_fallbacks")


def spec(key="gk", hits=1, limit=100, duration=60_000, **kw):
    kw.setdefault("behavior", GLOBAL)
    kw.setdefault("created_at", NOW)
    return dict(name="gm", unique_key=key, hits=hits, limit=limit,
                duration=duration, **kw)


class Pair:
    """A JAX engine and a port CPU engine driven in lockstep."""

    def __init__(self, j, t):
        self.j, self.t = j, t

    @property
    def n(self):
        return self.t.n_nodes

    def blocks(self, blocks, now):
        jr = self.j.process_blocks(
            [[JReq(**s) for s in blk] for blk in blocks], now=now)
        tr = self.t.process_blocks(
            [[RateLimitRequest(**s) for s in blk] for blk in blocks], now=now)
        for jb, tb in zip(jr, tr):
            assert [answer(r) for r in tb] == [answer(r) for r in jb]
        assert_same(self.j, self.t)
        return tr

    def process(self, specs, node, now):
        blocks = [[] for _ in range(self.n)]
        blocks[node] = specs
        return self.blocks(blocks, now)[node]

    def reconcile(self, now):
        self.j.reconcile(now=now)
        self.t.reconcile(now=now)
        assert_same(self.j, self.t)

    def peek(self, key):
        views = self.t.peek("gm_" + key)
        assert views == self.j.peek("gm_" + key)
        return views


def answer(r):
    return (r.status, r.limit, r.remaining, r.reset_time, r.error)


def jax_fields(j):
    """The reference test's ``_full_state``, every logical field."""
    return {f: np_logical(slice_field(getattr(j.state, f), (slice(None),)), f)
            for f in STATE_FIELDS}


def assert_same(j, t):
    jf, tf = jax_fields(j), t.state_fields()
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(tf[f], jf[f], err_msg=f)
    np.testing.assert_array_equal(t.aux.numpy(), np.asarray(j.aux))
    np.testing.assert_array_equal(t.accum.numpy(), np.asarray(j.accum))
    np.testing.assert_array_equal(t.slots.mapped_mask(), j.slots.mapped_mask())
    for c in COUNTERS:
        assert getattr(t, c) == getattr(j, c), c


def make_pair(capacity, max_batch, sparse_k, strict=True):
    j = JaxGlobal(mesh=make_global_mesh(N), capacity=capacity,
                  max_batch=max_batch, sparse_k=sparse_k,
                  strict_sequencing=strict)
    t = MeshGlobalEngine(n_nodes=N, capacity=capacity, max_batch=max_batch,
                         sparse_k=sparse_k, strict_sequencing=strict,
                         device="cpu")
    return Pair(j, t)


@pytest.fixture(scope="module")
def dense():
    return make_pair(64, 32, 0)


@pytest.fixture(scope="module")
def sparse32():
    return make_pair(256, 32, 32)


@pytest.fixture(scope="module")
def sparse4():
    return make_pair(256, 64, 4)


@pytest.fixture(scope="module")
def sparse8():
    return make_pair(256, 64, 8)


def owner_of(pair, key):
    slot = pair.j.slots.get("gm_" + key)
    return slot // (pair.t.capacity // pair.n)


# ----------------------------------------------------------------------
# The reference's scenarios (test_global_mesh.py:48-161), in its order
# ----------------------------------------------------------------------
def scenario_sums_hits(p):
    assert p.process([spec("sum", 3)], 1, NOW)[0].remaining == 97
    assert p.process([spec("sum", 4)], 2, NOW)[0].remaining == 96
    p.reconcile(NOW + 10)
    assert [v["remaining"] for v in p.peek("sum")] == [93] * N


def scenario_owner_direct(p):
    p.process([spec("own", 0)], 0, NOW)
    own = owner_of(p, "own")
    assert p.process([spec("own", 5)], own, NOW)[0].remaining == 95
    p.process([spec("own", 3)], (own + 1) % N, NOW)
    p.reconcile(NOW + 10)
    assert [v["remaining"] for v in p.peek("own")] == [92] * N


def scenario_overdraw(p):
    p.process([spec("drain", 6, limit=10)], 1, NOW)
    p.process([spec("drain", 6, limit=10)], 2, NOW)
    p.reconcile(NOW + 10)
    assert [v["remaining"] for v in p.peek("drain")] == [0] * N


def scenario_reset_folds(p):
    p.process([spec("rst", 9, limit=10)], 1, NOW)
    p.reconcile(NOW + 10)
    p.process([spec("rst", 1, limit=10, behavior=GLOBAL | RESET,
                    created_at=NOW + 20)], 2, NOW + 20)
    p.reconcile(NOW + 30)
    assert all(not v["in_use"] for v in p.peek("rst"))


def scenario_leaky(p):
    for h, node in ((2, 1), (3, 2)):
        p.process([spec("lk", h, limit=10, duration=10_000,
                        algorithm=LEAKY)], node, NOW)
    p.reconcile(NOW + 1)
    assert [v["remaining_f"] for v in p.peek("lk")] == [5.0] * N


def scenario_new_key_at_owner(p):
    p.process([spec("fresh", 2, limit=50)], 3, NOW)
    p.reconcile(NOW + 5)
    assert [v["remaining"] for v in p.peek("fresh")] == [48] * N


def scenario_second_window(p):
    p.process([spec("win", 10)], 1, NOW)
    p.reconcile(NOW + 10)
    p.reconcile(NOW + 20)
    assert p.peek("win")[0]["remaining"] == 90
    p.process([spec("win", 5, created_at=NOW + 25)], 2, NOW + 25)
    p.reconcile(NOW + 30)
    assert p.peek("win")[0]["remaining"] == 85


def scenario_mixed_nodes(p):
    out = p.blocks([[spec(f"mix-{i}", 1, limit=9) for i in range(3)]
                    for _ in range(N)], NOW)
    assert all(r.remaining == 8 for blk in out for r in blk)
    p.reconcile(NOW + 10)
    for i in range(3):
        assert [v["remaining"] for v in p.peek(f"mix-{i}")] == [9 - N] * N


SCENARIOS = [scenario_sums_hits, scenario_owner_direct, scenario_overdraw,
             scenario_reset_folds, scenario_leaky, scenario_new_key_at_owner,
             scenario_second_window, scenario_mixed_nodes]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[9:] for s in SCENARIOS])
def test_reference_scenarios(dense, scenario):
    scenario(dense)


def test_all_five_algorithms_and_negative_hits(dense):
    """Every algorithm hit on owners and non-owners, then negative hits
    (credits) queued on non-owners, over two reconciles."""
    t = NOW + 1_000
    blocks = [[spec(f"alg{a}-{k}", hits=1 + (d + k) % 3, limit=7,
                    duration=4_000, algorithm=a, created_at=t)
               for a in range(5) for k in range(2)]
              for d in range(N)]
    dense.blocks(blocks, t)
    dense.reconcile(t + 500)
    t += 1_000
    blocks = [[spec(f"alg{a}-{k}", hits=-(1 + d), limit=7, duration=4_000,
                    algorithm=a, created_at=t)
               for a in range(5) for k in range(2)]
              for d in range(N)]
    dense.blocks(blocks, t)
    dense.reconcile(t + 500)


def test_repeats_take_the_chained_tick_on_c2_corners(dense):
    """A node's block that repeats a leaky key takes B.5 (the x64
    transition one request after another, as the reference's rank
    rounds), never the merged tick's parts fold: keys whose rate is a
    negative non-integer (ROADMAP C.2: floor and truncation of the rate
    differ), an inexact rate and a fractional remainder, each hit several
    times in one block with identical parameters."""
    t = NOW + 5_000
    t_dense = dense.t
    w0, r0 = t_dense.metric_sorted_windows, fused_sorted_tick_plain.rounds
    keys = (("c2neg", -7_001, 2), ("c2frac", 1_000, 3), ("c2q", 30_000, 10))
    block = [spec(k, 1, limit=lim, duration=dur, algorithm=LEAKY, burst=0,
                  created_at=t) for k, dur, lim in keys for _ in range(4)]
    out = dense.process(block, 1, t)
    assert t_dense.metric_sorted_windows == w0 + 1
    assert fused_sorted_tick_plain.rounds >= r0 + 4
    assert [r.remaining for r in out[4:8]] == [2, 1, 0, 0]
    dense.reconcile(t + 100)
    block = [spec(k, 2, limit=lim, duration=dur, algorithm=LEAKY,
                  created_at=t + 700) for k, dur, lim in keys for _ in range(3)]
    dense.process(block, 2, t + 700)
    dense.reconcile(t + 800)


def test_reclaim_and_evict_on_a_full_table(dense):
    """More keys than the 64-slot table holds: expired keys are released,
    then live ones evicted least recently used first on every replica
    (their stamps and accumulators zeroed), the rest answered."""
    t = NOW + 200_000  # the earlier tests' keys have expired
    for w in range(3):
        blocks = [[spec(f"fill{w}-{d}-{k}", hits=1, limit=5,
                        duration=50_000, created_at=t + w)
                   for k in range(12)] for d in range(N)]
        dense.blocks(blocks, t + w)
        if w == 1:
            dense.reconcile(t + w)
    assert dense.t.cache_size() == dense.j.cache_size() <= 64


# ----------------------------------------------------------------------
# Sparse reconcile (test_global_mesh.py:261-457)
# ----------------------------------------------------------------------
def drive_specs(rng, windows=4, keys=24):
    out = []
    for _ in range(windows):
        blocks = []
        for _ in range(N):
            n = int(rng.integers(1, 8))
            blocks.append([
                spec(f"sk{int(rng.integers(0, keys))}",
                     hits=int(rng.integers(1, 4)), limit=50,
                     behavior=(GLOBAL | RESET if rng.random() < 0.1
                               else GLOBAL))
                for _ in range(n)])
        out.append(blocks)
    return out


def test_sparse_drive_matches_jax(sparse32):
    for w, blocks in enumerate(drive_specs(np.random.default_rng(7))):
        sparse32.blocks(blocks, NOW + w * 1000)
        sparse32.reconcile(NOW + w * 1000 + 500)
    assert sparse32.t.metric_dense_fallbacks == 0


def test_sparse_overflow_falls_back_dense(sparse4):
    rng = np.random.default_rng(11)
    blocks = [[spec(f"ov{int(rng.integers(0, 40))}", hits=1, limit=30)
               for _ in range(20)] for _ in range(N)]
    sparse4.blocks(blocks, NOW)
    d0 = sparse4.t.metric_reconcile_dispatches
    sparse4.reconcile(NOW + 10)
    assert sparse4.t.metric_dense_fallbacks == 1
    assert sparse4.t.metric_reconcile_dispatches == d0 + 2


def fuzz_window(rng, keys, width):
    return [[spec(f"fz{int(rng.integers(0, keys))}",
                  hits=int(rng.integers(1, 4)), limit=10_000,
                  behavior=(GLOBAL | RESET if rng.random() < 0.08
                            else GLOBAL))
             for _ in range(width)] for _ in range(N)]


def host_overflow(acc, cap, k):
    """The reference test's host recomputation (test_global_mesh.py:
    411-423): each node's first k window and touch slots, their union,
    each owner's share; overflow when a set or a share is too wide."""
    counts, touched = [], np.zeros(cap, bool)
    for d in range(acc.shape[0]):
        for row in (gm.ACC_COUNT, gm.ACC_TOUCH):
            mask = acc[d, row] > 0
            counts.append(int(mask.sum()))
            touched[np.flatnonzero(mask)[:k]] = True
    shares = touched.reshape(acc.shape[0], -1).sum(axis=1)
    return max(counts) > k or int(shares.max()) > 2 * k


def test_fused_step_fuzz_and_overflow_verdict(sparse8):
    rng = np.random.default_rng(3)
    seen = set()
    for w in range(6):
        width = 20 if w in (2, 4) else 3
        t = NOW + w * 1000
        sparse8.blocks(fuzz_window(rng, 40, width), t)
        want = host_overflow(sparse8.t.accum.numpy(), 256, 8)
        f0 = sparse8.t.metric_dense_fallbacks
        sparse8.reconcile(t)
        assert sparse8.t.last_overflow() == want
        assert sparse8.t.metric_dense_fallbacks == f0 + int(want)
        seen.add(want)
    assert seen == {True, False}


# ----------------------------------------------------------------------
# The non-strict dense step
# ----------------------------------------------------------------------
def test_non_strict_dense_step():
    p = make_pair(64, 32, 0, strict=False)
    rng = np.random.default_rng(21)
    for w in range(3):
        t = NOW + w * 2_000
        blocks = [[spec(f"ns{int(rng.integers(0, 12))}",
                        hits=int(rng.integers(-2, 5)), limit=20,
                        algorithm=int(rng.integers(0, 5)),
                        behavior=(GLOBAL | RESET if rng.random() < 0.1
                                  else GLOBAL), created_at=t)
                   for _ in range(6)] for _ in range(N)]
        p.blocks(blocks, t)
        p.reconcile(t + 100)


# ----------------------------------------------------------------------
# State carried across, and the plain versions on it
# ----------------------------------------------------------------------
def carried(pair, sparse_k=None):
    """A fresh port CPU engine holding ``pair``'s JAX state."""
    j = pair.j
    eng = MeshGlobalEngine(n_nodes=N, capacity=j.capacity,
                           max_batch=j.max_batch,
                           sparse_k=j.sparse_k if sparse_k is None
                           else sparse_k, device="cpu")
    mapped = np.flatnonzero(j.slots.mapped_mask())
    keys = {j.slots.key_of(int(s)): int(s) for s in mapped}
    import_reference_state(eng, jax_fields(j), np.asarray(j.aux),
                           np.asarray(j.accum), keys,
                           tick_count=j._tick_count)
    for c in COUNTERS:
        setattr(eng, c, getattr(j, c))
    return eng


def test_import_reference_state_then_dense_and_sparse_steps(dense, sparse8):
    for pair in (dense, sparse8):
        t = NOW + 400_000
        pair.blocks(fuzz_window(np.random.default_rng(5), 30, 3), t)
        eng = carried(pair)
        assert_same(pair.j, eng)
        mapped = np.flatnonzero(pair.j.slots.mapped_mask())
        keys = [pair.j.slots.key_of(int(s)).encode() for s in mapped]
        np.testing.assert_array_equal(
            eng.slots.lookup_blob(*pack_blob(keys)), mapped)
        pair.t = eng
        pair.reconcile(t + 10)
        # Keys the table holds: a new key's slot would depend on the slot
        # map's release history, which the import does not carry.
        rng = np.random.default_rng(6)
        held = [k.decode()[3:] for k in keys]
        pair.blocks([[spec(held[int(rng.integers(0, len(held)))],
                           hits=int(rng.integers(-1, 4)), limit=10_000,
                           created_at=t + 20)
                      for _ in range(3)] for _ in range(N)], t + 20)
        pair.reconcile(t + 30)


def test_plain_versions_against_the_jax_step(sparse8):
    """B.8b, B.8c and B.8d's plain versions on buffers carried across from
    the JAX engine, against its dense and sparse steps; B.8a through the
    carried engine's process step."""
    p = sparse8
    t = NOW + 500_000
    p.t = carried(p)
    p.blocks(fuzz_window(np.random.default_rng(8), 40, 3), t)
    eng = carried(p)
    out, slots, scratch = gm.probe_buffers(N, eng.capacity, "cpu")
    gm.global_sparse_probe_plain(eng.accum, N, 8, out, slots)
    assert int(out[0]) == host_overflow(eng.accum.numpy(), 256, 8) == 0
    gm.global_sparse_apply_plain(eng.table, eng.aux, eng.accum, N, slots,
                                 out, t)
    p.j.reconcile(now=t)
    jf, tf = jax_fields(p.j), eng.state_fields()
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(tf[f], jf[f], err_msg=f)
    np.testing.assert_array_equal(eng.accum.numpy(), np.asarray(p.j.accum))
    p.t.reconcile(now=t)
    # The strict dense step on carried buffers (the sparse engine's
    # fallback program).
    p.blocks(fuzz_window(np.random.default_rng(9), 40, 20), t + 10)
    eng = carried(p)
    gm.global_dense_reconcile_plain(eng.table, eng.aux, eng.accum, N, t + 10,
                                    strict=True)
    p.j.reconcile(now=t + 10)
    assert p.j.metric_dense_fallbacks >= 1
    jf, tf = jax_fields(p.j), eng.state_fields()
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(tf[f], jf[f], err_msg=f)
    np.testing.assert_array_equal(eng.accum.numpy(), np.asarray(p.j.accum))
    p.t = carried(p)


# ----------------------------------------------------------------------
# The kernels' slot code compiled for the host, against the plain versions
# ----------------------------------------------------------------------
def _host_lib():
    lib = _build.load("global_mesh_host")
    vp, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.gt_global_accumulate_host.argtypes = [vp, i64, i64, vp, vp, i64, i64,
                                              i64, i]
    lib.gt_global_dense_host.argtypes = [vp, vp, vp, i64, i64, i64, i]
    lib.gt_global_probe_host.argtypes = [vp, i64, i64, i64, vp, vp]
    lib.gt_global_apply_host.argtypes = [vp, vp, vp, i64, i64, vp, i64, i64]
    for f in (lib.gt_global_accumulate_host, lib.gt_global_dense_host,
              lib.gt_global_probe_host, lib.gt_global_apply_host):
        f.restype = None
    return lib


def random_buffers(rng, n, cap, touched=0.3):
    """Random replicas (every algorithm, odd rows), aux with stamps and
    accumulators with negative hits over a ``touched`` share of slots."""
    from tests.test_torch_common import gen_lanes

    state, _ = gen_lanes(rng, n * cap)
    rows = logical_to_rows({f: torch.from_numpy(np.asarray(state[f])).to(
        torch.float64 if f == "remaining_f" else torch.int64)
        for f in STATE_FIELDS})
    table = torch.cat([rows, torch.zeros((1, 16), dtype=torch.int64)])
    aux = np.zeros((n, len(gm.AUX_ROWS), cap), np.int64)
    _, req = gen_lanes(rng, n * cap)
    for k, f in enumerate(gm.AUX_ROWS[:-1]):
        aux[:, k] = np.asarray(req[f]).reshape(n, cap)
    aux[:, gm.AUX["stamp"]] = np.where(rng.random((n, cap)) < 0.7,
                                       rng.integers(1, 50, (n, cap)), 0)
    acc = np.zeros((n, gm.ACC_ROWS, cap), np.int64)
    hot = rng.random((n, cap)) < touched
    win = hot & (rng.random((n, cap)) < 0.6)
    acc[:, gm.ACC_COUNT] = np.where(win, rng.integers(1, 4, (n, cap)), 0)
    acc[:, gm.ACC_HITS] = np.where(win, rng.integers(-5, 20, (n, cap)), 0)
    acc[:, gm.ACC_RESET] = np.where(win & (rng.random((n, cap)) < 0.2), 1, 0)
    acc[:, gm.ACC_TOUCH] = np.where(hot, rng.integers(1, 5, (n, cap)), 0)
    return table, torch.from_numpy(aux), torch.from_numpy(acc)


def _ptr(t):
    return t.data_ptr()


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "summed"])
def test_host_dense_slot_code_matches_plain(strict):
    rng = np.random.default_rng(31)
    table, aux, acc = random_buffers(rng, N, 256)
    t2, a2 = table.clone(), acc.clone()
    gm.global_dense_reconcile_plain(table, aux, acc, N, NOW, strict)
    _host_lib().gt_global_dense_host(_ptr(t2), _ptr(aux), _ptr(a2), N, 256,
                                     NOW, int(strict))
    assert torch.equal(t2, table)
    assert torch.equal(a2, acc)


@pytest.mark.parametrize("k,n,stamped", [
    pytest.param(4, N, 0.7, id="4"), pytest.param(64, N, 0.7, id="64"),
    pytest.param(256, N, 0.7, id="256"),
    pytest.param(64, N, 0.0, id="64-running-row-only"),
    pytest.param(64, 24, 0.7, id="64-24-nodes"),
    pytest.param(4096, 24, 0.0, id="4096-24-nodes-running-row-only")])
def test_host_probe_and_apply_match_plain(k, n, stamped):
    """B.8c's and B.8d's host builds against the plain versions: 4-node
    meshes (a stamp on 70% of (node, slot) pairs, or on none, so that
    every window takes the running row's parameters and is prepared on
    the chain) and 24-node meshes; B.8d through its two halves, each
    node's window and then the chain."""
    cap = 64 * n
    rng = np.random.default_rng(32 + k + n - N)
    table, aux, acc = random_buffers(rng, n, cap, touched=0.05)
    aux[:, gm.AUX["stamp"]] *= torch.from_numpy(
        rng.random((n, cap)) < stamped / 0.7)
    out, slots, _ = gm.probe_buffers(n, cap, "cpu")
    gm.global_sparse_probe_plain(acc, n, k, out, slots)
    h_out = torch.zeros(2, dtype=torch.int64)
    h_slots = torch.zeros(cap, dtype=torch.int32)
    lib = _host_lib()
    lib.gt_global_probe_host(_ptr(acc), n, cap, k, _ptr(h_slots),
                             _ptr(h_out))
    assert torch.equal(h_out, out)
    assert torch.equal(h_slots[:int(out[1])], slots[:int(out[1])])
    t2, a2 = table.clone(), acc.clone()
    gm.global_sparse_apply_plain(table, aux, acc, n, slots, out, NOW)
    lib.gt_global_apply_host(_ptr(t2), _ptr(aux), _ptr(a2), n, cap,
                             _ptr(h_slots), int(h_out[1]), NOW)
    assert torch.equal(t2, table)
    assert torch.equal(a2, acc)


def test_host_accumulate_matches_plain():
    """A sorted window over flattened slots: repeats, queued and owned
    lanes, negative and zero hits, RESET, padding."""
    from gubernator_tpu_torch.ops.engine import (
        pack_cols_req32, sort_packed_by_slot)
    from gubernator_tpu_torch.ops.fusedtick import REQ32_INDEX
    from gubernator_tpu_torch.ops.reqcols import ReqColumns

    rng = np.random.default_rng(33)
    cap, lanes = 64, 200
    reqs = [RateLimitRequest(
        name="a", unique_key=str(k), hits=int(rng.integers(-3, 4)),
        limit=int(rng.integers(1, 50)), duration=int(rng.integers(0, 9000)),
        algorithm=int(rng.integers(0, 5)),
        behavior=int(rng.choice([GLOBAL, GLOBAL | RESET])),
        burst=int(rng.integers(0, 3)), created_at=NOW)
        for k in range(lanes)]
    cols = ReqColumns.from_requests(reqs)
    m = np.zeros((19, 256), np.int32)
    m[REQ32_INDEX["slot"]] = N * cap
    flat = rng.integers(0, N * cap // 4, lanes)
    pack_cols_req32(m, cols, flat, np.ones(lanes, np.int64), NOW,
                    slice(0, lanes))
    sort_packed_by_slot(m, lanes, N * cap)
    m_t = torch.from_numpy(m)
    for touch in (False, True):
        aux = torch.zeros((N, 9, cap), dtype=torch.int64)
        acc = torch.zeros((N, 4, cap), dtype=torch.int64)
        aux2, acc2 = aux.clone(), acc.clone()
        gm.global_accumulate_plain(m_t, aux, acc, N, 77, touch)
        _host_lib().gt_global_accumulate_host(
            _ptr(m_t), 256, 256, _ptr(aux2), _ptr(acc2), N, cap, 77,
            int(touch))
        assert torch.equal(aux2, aux)
        assert torch.equal(acc2, acc)
        assert int((acc[:, gm.ACC_COUNT] > 0).sum()) > 0


@pytest.mark.parametrize("sparse_k", [0, 8])
def test_cpu_engine_launches_no_kernel(sparse_k):
    """A CPU engine runs the plain versions: no kernel wrapper counts a
    launch through a window with repeats, a reconcile and an eviction."""
    import gubernator_tpu_torch as gt

    eng = MeshGlobalEngine(n_nodes=N, capacity=64, max_batch=32,
                           sparse_k=sparse_k, device="cpu")
    gt.reset_kernel_launches()
    reqs = [RateLimitRequest(**spec(f"nl{k % 3}", 1)) for k in range(6)]
    eng.process_blocks([reqs] * N, now=NOW)
    eng.reconcile(now=NOW + 10)
    eng.evict(np.array([0, 1]))
    assert eng.metric_sorted_windows == 1
    assert not any(gt.kernel_launches().values())


# ----------------------------------------------------------------------
# The service path: Cluster(global_mesh=True) and the knobs
# ----------------------------------------------------------------------
def _get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


async def test_cluster_global_mesh_service_path():
    """The reference's test_cluster_global_mesh_service_path
    (tests/test_global_mesh.py:217-255) on a 3-node port cluster on the
    CPU: GLOBAL hits on any daemon ride the shared engine and every node
    converges to limit - sum(hits) with no GLOBAL peer RPC; /metrics shows
    the three mesh counters; both column fast paths are off."""
    import asyncio
    import re

    from gubernator_tpu_torch.cluster import Cluster
    from gubernator_tpu_torch.config import BehaviorConfig

    behaviors = BehaviorConfig(global_sync_wait=0.03, batch_wait=0.002)
    c = await Cluster.start(3, behaviors=behaviors, global_mesh=True,
                            tpu_platform="cpu", cache_size=1024,
                            tpu_max_batch=64, http_gateway=True)
    try:
        def g(h):
            return RateLimitRequest(name="meshsvc", unique_key="mk", hits=h,
                                    limit=100, duration=60_000,
                                    behavior=GLOBAL)

        c0, c1, c2 = (d.client() for d in c.daemons)
        out = await c0.get_rate_limits([g(5)])
        assert out[0].error == "" and out[0].remaining == 95
        out = await c1.get_rate_limits([g(7)])
        assert out[0].error == "" and out[0].remaining in (93, 88)

        async def synced():
            while True:
                resp = await c2.get_rate_limits([g(0)])
                if resp[0].remaining == 88:
                    return
                await asyncio.sleep(0.02)

        await asyncio.wait_for(synced(), timeout=5.0)
        eng = c.daemons[0].instance.global_mesh
        assert eng.metric_reconciles > 0
        assert all(d.instance.global_mesh is eng for d in c.daemons)
        assert [d.instance.conf.global_mesh_node for d in c.daemons] == [
            0, 1, 2]
        for view in eng.peek("meshsvc_mk"):
            assert view["remaining"] == 88
        steps = 0
        for d in c.daemons:
            assert not d.instance.columns_fast_path_ok()
            assert not d.instance.peer_columns_fast_path_ok()
            text = await asyncio.to_thread(
                _get, f"http://{d.conf.http_listen_address}/metrics")
            for fam in ("gubernator_tpu_mesh_reconcile_count",
                        "gubernator_tpu_mesh_reconcile_dispatches",
                        "gubernator_tpu_mesh_dense_fallbacks"):
                assert f"# TYPE {fam}_total counter" in text, fam
            assert not re.search(r'PeersV1[^\n]*\} [1-9]', text)
            for fam in ("gubernator_global_send_duration_count",
                        "gubernator_broadcast_duration_count"):
                assert d.metrics.sample(fam) == 0, fam
            steps += d.metrics.sample(
                "gubernator_tpu_mesh_reconcile_count_total")
            assert d.metrics.sample(
                "gubernator_tpu_mesh_dense_fallbacks_total") == 0
        assert 0 < steps <= eng.metric_reconciles
        for cl in (c0, c1, c2):
            await cl.close()
    finally:
        await c.stop()


async def test_knobs_build_a_nodes_own_engine():
    """GUBER_TPU_GLOBAL_MESH_NODES=4 makes a node build its own engine
    (node -1, auto, is 0), and its GLOBAL items ride it; that node refuses
    other peers, by ``set_peers`` or by discovery."""
    from gubernator_tpu_torch import config
    from gubernator_tpu_torch.transport.daemon import spawn_daemon

    conf = config.setup_daemon_config(environ={
        "GUBER_GRPC_ADDRESS": "127.0.0.1:0", "GUBER_HTTP_ADDRESS": "",
        "GUBER_TPU_PLATFORM": "cpu", "GUBER_CACHE_SIZE": "256",
        "GUBER_TPU_MAX_BATCH": "64", "GUBER_TPU_GLOBAL_MESH_NODES": "4",
        "GUBER_TPU_GLOBAL_MESH_CAPACITY": "128"})
    d = await spawn_daemon(conf)
    try:
        eng = d.instance.global_mesh
        assert (eng.n_nodes, eng.capacity, eng.device.type) == (4, 128, "cpu")
        assert d.instance.conf.global_mesh_node == 0
        assert eng.min_reconcile_ms == 50
        cl = d.client()
        out = await cl.get_rate_limits([RateLimitRequest(
            name="own", unique_key="k", hits=3, limit=10, duration=60_000,
            behavior=GLOBAL)])
        await cl.close()
        assert out[0].remaining == 7
        assert [v["remaining"] for v in eng.peek("own_k")][0] == 7
        # The mesh lives in this process: a peer set with another node
        # is refused and leaves the node standalone.
        with pytest.raises(ValueError, match="lives in this process"):
            d.set_peers([d._self_info(), PeerInfo(
                grpc_address="127.0.0.1:1", http_address="")])
        assert d.instance._standalone
        assert [p.info.grpc_address
                for p in d.instance.local_picker.peers()] == [
            d.advertise_address]
    finally:
        await d.close()
    conf.peer_discovery_type = "etcd"  # refused before discovery starts
    with pytest.raises(ValueError, match="lives in this process"):
        await spawn_daemon(conf)
    conf.peer_discovery_type = "none"
    conf.config.tpu_global_mesh_node = 4  # past the mesh's 4 nodes
    with pytest.raises(ValueError, match="GUBER_TPU_GLOBAL_MESH_NODE"):
        await spawn_daemon(conf)
