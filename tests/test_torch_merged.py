"""Duplicate windows in the port against the JAX package: the grouped and
layered host plans, the merged tick (kernel B.3) and its fold, the member
expansion, both pipelines and the engine's dispatch.

Every comparison is exact (tolerance 0): the values are int32, int64 and
float64 produced by the same correctly rounded operations on both sides.
The JAX references are the programs the JAX engine runs for grouped and
layered windows on the columns layout (``transition32.merged_fold32`` and
``_expand_members``), not the x64 ``engine._merged_formulas``; the cases
where the two differ are pinned in
``test_merged_pipeline_matches_jax_herd_cases`` (ROADMAP queue C).  Leaky
(duration, limit) pairs come from the exact-quotient pool and stored
``updated_at`` values lie a multiple of every such rate before ``now``,
so every leak is exact: the JAX programs keep ``remaining_f`` as a triple
of float32, which rounds like float64 only for exact rates, and whose
fold subtraction after an inexact leak keeps bits float64 drops.

The JAX programs compiled here are few and shared: the merged rows
program at capacity 256 with 256 heads (inside ``jitted_merged_pipeline``,
which the capacity-256 engine also runs) and the layered pipeline at
capacity 2^14 with 256 layer-0 heads and 4 layers (which the 2^14 engine
also runs).  The JAX engines skip their constructor warmup, which only
compiles programs these windows never reach.  B.3 never runs in Pallas
interpret mode here.
"""

import ctypes
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gubernator_tpu.ops import engine as jeng
from gubernator_tpu.ops.buckets import BucketState, np_logical, stored_view
from gubernator_tpu.ops.reqcols import ReqColumns as JReqColumns
from gubernator_tpu.ops.tick32 import (
    jitted_layered_pipeline, jitted_merged_pipeline)
from gubernator_tpu.ops.transition32 import expand32_rowmajor
from gubernator_tpu_torch import _build
from gubernator_tpu_torch.carry import columns_from_table, table_from_columns
from gubernator_tpu_torch.ops import engine as teng
from gubernator_tpu_torch.ops import tick
from gubernator_tpu_torch.ops.buckets import STATE_FIELDS
from gubernator_tpu_torch.ops.engine import TickEngine
from gubernator_tpu_torch.ops.fusedtick import (
    fused_merged_tick, fused_merged_tick_plain, fused_tick_plain)
from gubernator_tpu_torch.ops.reqcols import ReqColumns as TReqColumns
from gubernator_tpu_torch.types import Behavior
from tests.test_torch_common import (
    NOW, edge_lanes, gen_lanes, pack_m32, teng_pack)
from tests.test_torch_cuda import (
    MERGED_KINDS, MERGED_WIDTHS, division_case, merged_case)
from tests.test_torch_engine import keyset, run_windows

CAP = 256          # grouped: merged pipeline and its engine
LCAP = 1 << 14     # layered: the JAX engine's gate for the layered plan
B = 64             # window width (the engines' max_batch)
UPAD = 256         # group_upad(64): the merged head width
KPAD = 4           # layered windows here plan 3 or 4 unit layers
# Limits that divide the 60 s duration: exact leaky rates.
LIMITS = (2, 3, 4, 5, 6, 8, 10, 12, 15, 16, 20, 24, 25)
RESET = int(Behavior.RESET_REMAINING)
DRAIN = int(Behavior.DRAIN_OVER_LIMIT)
GREG = int(Behavior.DURATION_IS_GREGORIAN)
R = teng.REQ32_INDEX
_I32 = ("algorithm", "status")
ECHO_ROWS = [R["hits"], R["hits"] + 1, R["limit"], R["limit"] + 1,
             R["created_at"], R["created_at"] + 1, R["algorithm"],
             R["behavior"]]


# ----------------------------------------------------------------------
# Inputs
# ----------------------------------------------------------------------
def packed(rows, b=B, cap=CAP):
    """A slot-sorted (19, b) REQ32 window from request dicts (in order);
    lanes past ``len(rows)`` are padding."""
    n = len(rows)
    m = np.zeros((teng.REQ32_ROWS, b), np.int32)
    m[R["slot"]] = cap
    for f in ("slot", "known", "algorithm", "behavior"):
        m[R[f], :n] = [r.get(f, 0) for r in rows]
    m[R["valid"], :n] = [r.get("valid", 1) for r in rows]
    for f in teng.REQ32_WIDE:
        teng.pack_wide_rows(m, f, [r.get(f, 0) for r in rows], slice(0, n))
    return m, n


def group(slot, count, known_head=1, **params):
    """``count`` identical requests on ``slot``; all but the head known."""
    base = dict(dict(hits=1, limit=10, duration=60_000, created_at=NOW),
                slot=slot, **params)
    return [dict(base, known=known_head if i == 0 else 1)
            for i in range(count)]


def random_state(rng, cap):
    """``gen_lanes`` state over ``cap`` slots whose leaks are exact: every
    ``updated_at`` lies a multiple of 18 s (a multiple of each exact-pool
    rate) from NOW."""
    state = gen_lanes(rng, cap)[0]
    state["updated_at"] = NOW - 18_000 * rng.integers(-1, 7, cap)
    return state


def zero_state(cap):
    cols = {f: np.zeros(cap, np.float64 if f == "remaining_f" else np.int64)
            for f in STATE_FIELDS}
    cols["in_use"] = np.zeros(cap, bool)
    return cols


def set_slot(cols, slot, **vals):
    cols["in_use"][slot] = True
    cols["expire_at"][slot] = NOW + 60_000
    for f, v in vals.items():
        cols[f][slot] = v


def jax_state(cols):
    return stored_view(BucketState(**{
        f: jnp.asarray(cols[f], jnp.int32 if f in _I32 else None)
        for f in STATE_FIELDS}))


def assert_state_equal(table, js):
    got = columns_from_table(table)
    for f in STATE_FIELDS:
        want = np_logical(getattr(js, f), f)
        if f == "remaining_f":
            np.testing.assert_array_equal(got[f].view(np.int64),
                                          want.view(np.int64), err_msg=f)
        else:
            np.testing.assert_array_equal(got[f].astype(np.int64),
                                          want.astype(np.int64), err_msg=f)


def as_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def herd_window(rng, n_keys, cap):
    """Rows of a herd window (at most B): Zipf-sized groups of identical
    requests on ``n_keys`` slots, token and leaky, exact rates, all
    created at NOW."""
    pool = [(30_000, 10), (60_000, 1000), (1_000, 4), (5_000, 5)]
    slots = np.sort(rng.choice(cap, n_keys, replace=False))
    sizes = np.minimum(rng.zipf(1.3, n_keys), 12)
    rows = []
    for s, k in zip(slots, sizes):
        if len(rows) + k > B:
            break
        d, lim = pool[rng.integers(len(pool))]
        rows += group(int(s), int(k), known_head=int(rng.random() < 0.6),
                      hits=int(rng.choice([1, 2, 3, 7])), limit=lim,
                      duration=d, algorithm=int(rng.integers(0, 2)),
                      behavior=int(rng.choice([0, 0, DRAIN, 1, 16])),
                      burst=int(rng.choice([0, 0, 5])))
    return rows


def mixed_window(rng, cap, now=NOW):
    """Slot-sorted window of B - 4 rows: three hot keys whose runs break on
    RESET rows and parameter changes (the layered plan's shape), the
    rest unique keys over all five algorithms."""
    rows = []
    hot = np.sort(rng.choice(cap, 3, replace=False))
    for s in hot:
        hits, limit = int(rng.integers(1, 4)), int(rng.choice(LIMITS))
        alg = int(rng.integers(0, 2))
        for i in range(int(rng.integers(8, 14))):
            if rng.random() < 0.15:
                hits, limit = int(rng.integers(1, 4)), int(rng.choice(LIMITS))
            beh = RESET if rng.random() < 0.12 else 0
            rows.append(dict(slot=int(s), known=int(i > 0), hits=hits,
                             limit=limit, duration=60_000, created_at=now,
                             algorithm=alg, behavior=beh))
    taken = set(hot.tolist())
    rest = [s for s in rng.permutation(cap)[:B] if s not in taken]
    for s in sorted(rest[:B - len(rows) - 4]):
        rows.append(dict(slot=int(s), known=1, hits=int(rng.integers(0, 3)),
                         limit=10, duration=60_000, created_at=now,
                         algorithm=int(rng.integers(0, 5))))
    rows.sort(key=lambda r: r["slot"])
    return rows


def layered_plan_window(rng, cap, now=NOW):
    """A mixed window whose layered plan has KPAD layers."""
    for _ in range(200):
        m, n = packed(mixed_window(rng, cap, now=now), cap=cap)
        plan = teng.build_layer_plan(m, n, cap, now)
        if (plan is not None and plan[-1] == KPAD
                and teng.build_group_plan(m, n, cap, now) is None):
            return m, n, plan
    raise AssertionError("no layered window")


# ----------------------------------------------------------------------
# The JAX programs (compiled once per module)
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_merged():
    """``jitted_merged_pipeline(CAP, "columns")`` and the merged rows
    program inside it (``jax.jit(make_merged_tick32_rows_fn(CAP,
    "columns"))``), taken from its closure so both share one compile."""
    run = jitted_merged_pipeline(CAP, "columns")
    free = dict(zip(run.__code__.co_freevars,
                    (c.cell_contents for c in run.__closure__)))

    def rows(state, mhead, count, now):
        s, r = free["inner"](state, jnp.asarray(mhead), jnp.asarray(count),
                             jnp.int64(now))
        return s, np.stack([np.asarray(x) for x in r])

    def pipeline(state, mhead, count, uidx, rank, now):
        s, r = run(state, *(jnp.asarray(a) for a in (mhead, count, uidx,
                                                      rank)),
                   jnp.int64(now))
        return s, np.asarray(r)

    return rows, pipeline


def jax_layered(state, plan, m, now):
    mh0, cnt0, mhk, cntk, uidx, rank, kpad = plan
    fn = jitted_layered_pipeline(LCAP, "columns", mh0.shape[1], kpad)
    s, r = fn(state, *(jnp.asarray(a) for a in (mh0, cnt0, mhk, cntk, m,
                                                uidx, rank)),
              jnp.int64(now))
    return s, np.asarray(r)


def jax_engine(capacity):
    with mock.patch.object(jeng.TickEngine, "_warmup", lambda self: None):
        return jeng.TickEngine(capacity=capacity, max_batch=B,
                               table_layout="columns")


# ----------------------------------------------------------------------
# Host plans
# ----------------------------------------------------------------------
def assert_plans_equal(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None and len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def plans_agree(m, n, cap, now=NOW, **kw):
    """Both packages' grouped and layered plans of one window; returns the
    port's."""
    g = teng.build_group_plan(m.copy(), n, cap, now)
    assert_plans_equal(g, jeng.build_group_plan(m.copy(), n, cap, now))
    lp = teng.build_layer_plan(m.copy(), n, cap, now, **kw)
    assert_plans_equal(lp, jeng.build_layer_plan(m.copy(), n, cap, now, **kw))
    return g, lp


def test_plans_match_jax_on_random_windows():
    rng = np.random.default_rng(1)
    grouped = layered = 0
    for k in range(24):
        rows = herd_window(rng, 40, CAP) if k % 2 else mixed_window(rng, CAP)
        if k % 6 == 5:   # per-item errors: lanes at the guard slot
            rows = rows[:B - 3] + [dict(slot=CAP, valid=0)] * 3
        m, n = packed(rows)
        g, lp = plans_agree(m, n, CAP)
        grouped += g is not None
        layered += lp is not None
    assert grouped >= 8 and layered >= 8
    assert teng.group_upad(64) == jeng.group_upad(64) == UPAD
    assert teng.group_upad(32768, 7857) == jeng.group_upad(32768, 7857) == 8192


@pytest.mark.parametrize("case", [
    "reset_follower", "hits_change", "query_follower", "limit_change",
    "unknown_follower", "greg_follower", "zoo_follower", "negative_hits",
    "dead_duration", "backdated", "unique", "shallow", "errors_only"])
def test_group_plan_none_cases_match_jax(case):
    """Every window test_group_plan.py sends to the rank rounds, and the
    gates around them: both packages decline it."""
    a = dict(slot=3, known=1, hits=1, limit=10, duration=60_000,
             created_at=NOW)
    two = {
        "reset_follower": [a, dict(a, behavior=RESET)],
        "hits_change": [dict(a, hits=2), dict(a, hits=3)],
        "query_follower": [a, dict(a, hits=0)],
        "limit_change": [dict(a, limit=5), dict(a, limit=6)],
        "unknown_follower": [a, dict(a, known=0)],
        "greg_follower": [dict(a, behavior=GREG)] * 2,
        "zoo_follower": [dict(a, algorithm=3)] * 2,
        "negative_hits": [dict(a, hits=-2)] * 2,
        "dead_duration": [dict(a, duration=-5)] * 3,
        "backdated": [dict(a, created_at=NOW - 10_000)] * 3,
        "unique": [dict(a, slot=s) for s in range(8)],
        # one duplicate among 20 live rows: under min_dup_frac
        "shallow": [dict(a, slot=s) for s in range(19)] + [dict(a, slot=18)],
        "errors_only": [dict(slot=CAP, valid=0)] * 4,
    }[case]
    m, n = packed(two)
    assert teng.build_group_plan(m, n, CAP, NOW) is None
    assert jeng.build_group_plan(m, n, CAP, NOW) is None


@pytest.mark.parametrize("case", ["dead_unit_head", "overdeep", "overwide",
                                  "shallow", "errors_only"])
def test_layer_plan_none_cases_match_jax(case):
    """test_layered.py's declined windows (a count > 1 unit under a head
    that is not provably alive, a slot with more than 32 units), a second
    layer wider than 512 units, and the min_dup_frac gate."""
    a = dict(known=1, hits=1, limit=5, duration=60_000, created_at=NOW)
    b, cap = B, CAP
    if case == "dead_unit_head":
        rows = [dict(a, slot=0, duration=-5)] * 4
    elif case == "overdeep":
        rows = [dict(a, slot=0, hits=h) for h in range(1, 41)]
    elif case == "overwide":
        b, cap = 2048, 1024
        rows = [r for s in range(600)
                for r in (dict(a, slot=s), dict(a, slot=s, behavior=RESET))]
    elif case == "shallow":
        rows = [dict(a, slot=s) for s in range(30)] + [dict(a, slot=29)]
    else:
        rows = [dict(slot=CAP, valid=0)] * 4
    m, n = packed(rows, b=b, cap=cap)
    assert teng.build_layer_plan(m, n, cap, NOW) is None
    assert jeng.build_layer_plan(m, n, cap, NOW) is None
    if case == "overwide":   # the same window fits 1024-wide layers
        plans_agree(m, n, cap, layer_width=1024)


# ----------------------------------------------------------------------
# The merged tick, its fold and its host lane code
# ----------------------------------------------------------------------
def merged_inputs(rng, cap, u=UPAD, live=100, exact=True, edges=False,
                  max_count=9):
    """Random state over every slot and ``live`` slot-sorted unique heads
    (all five algorithms, every behavior) padded to ``u``, each with a
    random group size; optionally the edge lanes in extra slots."""
    state = (random_state(rng, cap) if exact
             else gen_lanes(rng, cap, exact=False)[0])
    _, req = gen_lanes(rng, live, exact=exact)
    slots = np.sort(rng.choice(cap, live, replace=False))
    if edges:
        es, er = edge_lanes()
        k = len(er["hits"])
        for f in STATE_FIELDS:
            state[f] = np.concatenate([state[f], es[f].astype(state[f].dtype)])
        for f in req:
            req[f] = np.concatenate([req[f], er[f].astype(req[f].dtype)])
        slots = np.concatenate([slots, np.arange(cap, cap + k)])
        cap += k
        live += k
    m = pack_m32(req, slots, u, cap)
    count = np.ones(u, np.int32)
    count[:live] = rng.integers(1, max_count, live)
    return state, m, count, cap, live


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_merged_tick_matches_jax_rows(jax_merged, seed):
    rows_fn, _ = jax_merged
    rng = np.random.default_rng(seed)
    state, m, count, _, live = merged_inputs(rng, CAP)
    js, jrows = rows_fn(jax_state(state), m, count, NOW)
    table = table_from_columns(state, CAP, "cpu")
    r24 = fused_merged_tick(table, *as_torch(m, count), NOW).numpy()
    np.testing.assert_array_equal(r24[:live, :15].T, jrows[:, :live])
    np.testing.assert_array_equal(r24[:live, 15:23].T, m[ECHO_ROWS, :live])
    assert (r24[:, 23] == 0).all() and (r24[live:] == 0).all()
    assert_state_equal(table, js)
    assert (table[CAP] == 0).all()


def _host_lib():
    lib = _build.load("fused_tick_host")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    fn = lib.gt_fused_merged_tick_host
    fn.restype = ctypes.c_int
    fn.argtypes = [vp, i64, vp, i64, vp, vp, i64, i64]
    return fn


@pytest.mark.parametrize("seed,exact", [(3, True), (4, False)])
def test_kernel_lane_code_on_host_matches_plain(seed, exact):
    """csrc/transition.cuh's transition and fold, built for the host,
    against the plain version bit for bit: inexact rates, edge lanes
    (NaN/inf/huge remainders, wrapping products) and group sizes up to
    1000."""
    rng = np.random.default_rng(seed)
    state, m, count, cap, _ = merged_inputs(rng, CAP, exact=exact,
                                            edges=True, max_count=1000)
    t_plain = table_from_columns(state, cap, "cpu")
    t_host = t_plain.clone()
    mt, ct = as_torch(m, count)
    j_plain = fused_merged_tick_plain(
        t_plain, mt, ct, NOW, torch.empty((m.shape[1], 24), dtype=torch.int32))
    j_host = torch.full((m.shape[1], 24), -7, dtype=torch.int32)
    assert _host_lib()(t_host.data_ptr(), cap, mt.data_ptr(), mt.stride(0),
                       ct.data_ptr(), j_host.data_ptr(), m.shape[1], NOW) == 0
    assert torch.equal(j_host, j_plain)
    assert torch.equal(t_host, t_plain)


def host_merged_matches_plain(state, m, count, width):
    """The host build of the merged tick's tile steps against the plain
    version on the first ``width`` heads of ``m`` (a column slice: ld_m >
    U when ``m`` is wider), its journal a row slice of a wider one: rows
    and journal bit for bit, rows outside the slice untouched."""
    cap = len(state["algorithm"])
    t_plain = table_from_columns(state, cap, "cpu")
    t_host = t_plain.clone()
    mt = torch.from_numpy(m)[:, :width]
    ct = torch.from_numpy(count[:width].copy())
    j_plain = fused_merged_tick_plain(
        t_plain, mt, ct, NOW, torch.empty((width, 24), dtype=torch.int32))
    journal = torch.full((width + 16, 24), -7, dtype=torch.int32)
    assert _host_lib()(t_host.data_ptr(), cap, mt.data_ptr(), mt.stride(0),
                       ct.data_ptr(), journal[8:].data_ptr(), width,
                       NOW) == 0
    assert torch.equal(journal[8:8 + width], j_plain)
    assert (journal[:8] == -7).all() and (journal[8 + width:] == -7).all()
    assert torch.equal(t_host, t_plain)


@pytest.mark.parametrize("width", MERGED_WIDTHS)
@pytest.mark.parametrize("kind", MERGED_KINDS)
def test_merged_tile_code_on_host_matches_plain(kind, width):
    """The merged kernel's tile steps (csrc/tile.cuh MergedOut) at the tile
    shapes: one head, the narrow path's edge (8 / 9 heads), the 64-head
    tile's edges, 255-257 heads and a 512-head layer; padding and invalid
    heads among the live ones, group sizes up to 1000."""
    host_merged_matches_plain(*merged_case(kind, width, seed=width), width)


def test_merged_fold_division_edges_on_host_match_plain():
    """The fold's divisions at their 32-bit path's edges: rate_i over
    limits -7, 0, 1, 2^31 - 1, 2^32 - 1, 2^32, 2^32 + 1 and durations
    -5, 0, 2^32 - 1, 2^32; q over bases and hits around 2^32."""
    state, m, count = division_case()
    host_merged_matches_plain(state, m, count, m.shape[1])
    # the heads do fold: the journal's q and rate_i reach past 2^32
    t = table_from_columns(state, len(state["algorithm"]), "cpu")
    j = fused_merged_tick_plain(
        t, torch.from_numpy(m), torch.from_numpy(count), NOW,
        torch.empty((m.shape[1], 24), dtype=torch.int32)).numpy()
    assert (j[:, 9] != 0).any() and (j[:, 11] != 0).any()


def test_count_one_is_the_fused_tick():
    rng = np.random.default_rng(5)
    state, m, count, _, live = merged_inputs(rng, CAP, exact=False)
    count[:] = 1
    t1 = table_from_columns(state, CAP, "cpu")
    t2 = t1.clone()
    r24 = fused_merged_tick(t1, *as_torch(m, count), NOW)
    r6 = fused_tick_plain(t2, torch.from_numpy(m), NOW,
                          torch.empty((6, m.shape[1]), dtype=torch.int32))
    assert torch.equal(r24[:, :6].T, r6)
    assert torch.equal(t1, t2)


def test_merged_tick_into_journal_slices():
    """Launches that write row slices of one flat journal (the layered
    pipeline) match launches that own their output."""
    rng = np.random.default_rng(6)
    state, m, count, _, _ = merged_inputs(rng, CAP, u=64, live=40)
    t1 = table_from_columns(state, CAP, "cpu")
    t2 = t1.clone()
    mt, ct = as_torch(m, count)
    whole = torch.cat([fused_merged_tick(t1, mt[:, :24], ct[:24], NOW),
                       fused_merged_tick(t1, mt[:, 24:], ct[24:], NOW)])
    journal = torch.full((80, 24), -1, dtype=torch.int32)
    fused_merged_tick(t2, mt[:, :24], ct[:24].clone(), NOW, out=journal[8:32])
    fused_merged_tick(t2, mt[:, 24:], ct[24:].clone(), NOW, out=journal[32:72])
    assert torch.equal(journal[8:72], whole)
    assert (journal[:8] == -1).all() and (journal[72:] == -1).all()
    assert torch.equal(t1, t2)
    with pytest.raises(ValueError):
        fused_merged_tick(t2, mt, ct[:10], NOW)


# ----------------------------------------------------------------------
# The member expansion
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["folds", "wrapping"])
def test_expand_rowmajor_matches_jax(kind):
    rng = np.random.default_rng(7)
    u, b = 96, 300
    if kind == "wrapping":
        r24 = rng.integers(-2**31, 2**31, (u, 24)).astype(np.int32)
        r24[:, 12] = rng.integers(0, 2, u)
    else:
        def put(k, v):
            r24[:, k] = (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
            r24[:, k + 1] = (v >> 32).astype(np.int32)

        r24 = np.zeros((u, 24), np.int32)
        r24[:, :6] = rng.integers(-5, 50, (u, 6))
        base = rng.integers(-20, 200, u)
        hits = rng.choice([-3, 0, 1, 2, 5, 7], u)
        put(6, base)
        put(8, np.maximum(base, 0) // np.where(hits > 0, hits, 1))
        put(10, rng.integers(0, 70_000, u))
        r24[:, 12] = rng.integers(0, 2, u)
        put(13, NOW + rng.integers(0, 60_000, u))
        put(15, hits)
        put(17, rng.choice([1, 10, 1000, 2**40], u))
        put(19, NOW - rng.integers(0, 1_000, u))
    r24[:, 21] = rng.integers(0, 2, u)
    r24[:, 22] = rng.choice([0, DRAIN, DRAIN | 1, 8], u)
    uidx = rng.integers(0, u, b).astype(np.int32)
    rank = rng.integers(0, 40, b).astype(np.int32)
    rank[::5] = 0
    want = np.stack([np.asarray(x) for x in jax.jit(expand32_rowmajor)(
        jnp.asarray(r24), jnp.asarray(uidx), jnp.asarray(rank))])
    got = tick.expand_rowmajor(*as_torch(r24, uidx, rank))
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------------
# The pipelines
# ----------------------------------------------------------------------
def herd_cases():
    """test_merge_fastpath.py's herd cases, each a (rows, stored state)
    pair on its own slots: exact remainder and the at-zero status flip,
    drain, a persisted OVER status, a leaky fraction kept through
    decrements, leaky exact remainder and drain zeroing the fraction, a
    negative post-head remaining (token and leaky: base is floor, q clamps
    at 0), and an inexact duration / limit with updated_at == now, where
    the fold's integer rate_i shows in the followers' reset times and the
    leak does not."""
    cols = zero_state(CAP)
    rows = []
    rows += group(1, 8, known_head=0, hits=2, limit=10)
    rows += group(2, 8, known_head=0, hits=2, limit=10, behavior=DRAIN)
    rows += group(3, 32, known_head=0, hits=3, limit=10)
    set_slot(cols, 4, limit=10, remaining=5, duration=60_000,
             created_at=NOW - 500, status=1)
    rows += group(4, 8, hits=1, limit=10)
    for s, remf in ((5, 7.625), (6, 6.5), (7, 0.875)):
        set_slot(cols, s, algorithm=1, limit=10, remaining_f=remf,
                 duration=60_000, burst=10, updated_at=NOW)
        rows += group(s, 6, hits=2, limit=10, algorithm=1)
    rows += group(8, 12, known_head=0, hits=3, limit=10, algorithm=1,
                  behavior=DRAIN)
    set_slot(cols, 9, limit=10, remaining=-7, duration=60_000,
             created_at=NOW - 500)
    rows += group(9, 4, hits=2, limit=10)
    set_slot(cols, 10, algorithm=1, limit=10, remaining_f=-2.5,
             duration=60_000, burst=10, updated_at=NOW)
    rows += group(10, 4, hits=1, limit=10, algorithm=1)
    set_slot(cols, 11, algorithm=1, limit=3, remaining_f=2.0, duration=1_000,
             burst=3, updated_at=NOW)
    rows += group(11, 5, hits=1, limit=3, duration=1_000, algorithm=1)
    return rows, cols


def run_merged_pipelines(jpipe, rows, cols, b):
    m, n = packed(rows, b=b)
    plan = teng.build_group_plan(m, n, CAP, NOW)
    assert plan is not None
    mhead, count, uidx, rank, _ = plan
    js, want = jpipe(jax_state(cols), mhead, count, uidx, rank, NOW)
    table = table_from_columns(cols, CAP, "cpu")
    got = tick.merged_pipeline(table, *as_torch(mhead, count, uidx, rank),
                               NOW)
    assert_state_equal(table, js)
    return got.numpy()[:, :n], want[:, :n], m[R["slot"], :n], rank[:n]


def test_merged_pipeline_matches_jax_herd_cases(jax_merged):
    got, want, slot, rank = run_merged_pipelines(
        jax_merged[1], *herd_cases(), b=2 * B)
    # The one lane that differs is slot 10's head, and not through the
    # fold: its own transition truncates the leaky -2.5 to -2 (the x64
    # bucket_transition, which the port's transition follows) where
    # transition32 floors it to -3 (ROADMAP queue C).
    head10 = (slot == 10) & (rank == 0)
    np.testing.assert_array_equal(got[:, ~head10], want[:, ~head10])
    assert got[2, head10] == -2 and want[2, head10] == -3
    # Where merged_fold32 and the x64 _merged_formulas part ways: the
    # leaky base floors -2.5 to -3 (x64: -2), and q clamps a negative
    # token base at 0 (x64: base // h < 0), so every follower answers
    # the floored residue over the limit.
    assert (got[2, (slot == 10) & (rank > 0)] == -3).all()
    assert (got[2, (slot == 9) & (rank > 0)] == -7).all()
    assert (got[0, (slot == 9) & (rank > 0)] == 1).all()


def test_merged_pipeline_matches_jax_random(jax_merged):
    rng = np.random.default_rng(8)
    got, want, _, _ = run_merged_pipelines(
        jax_merged[1], herd_window(rng, 30, CAP), random_state(rng, CAP), B)
    np.testing.assert_array_equal(got, want)


def test_layered_pipeline_matches_jax():
    """One window of three or four unit layers over random stored state
    (each JAX layered window costs seconds of XLA:CPU time, so the chain
    across windows is checked at the engine level)."""
    rng = np.random.default_rng(9)
    cols = random_state(rng, LCAP)
    m, n, plan = layered_plan_window(rng, LCAP)
    js, want = jax_layered(jax_state(cols), plan, m, NOW)
    mh0, cnt0, mhk, cntk, uidx, rank, _ = plan
    table = table_from_columns(cols, LCAP, "cpu")
    got = tick.layered_pipeline(
        table, *as_torch(mh0, cnt0, mhk, cntk, uidx, rank), NOW)
    np.testing.assert_array_equal(got.numpy()[:, :n], want[:, :n])
    assert_state_equal(table, js)


# ----------------------------------------------------------------------
# The engine's dispatch
# ----------------------------------------------------------------------
def herd_columns(rng, ids, now, leaky_keys):
    """Herd requests over keys ``ids``: every request for one key is the
    same request (token, or leaky for ``leaky_keys``), server-stamped."""
    n = len(ids)
    pool = np.array([(30_000, 10), (60_000, 1000), (1_000, 4), (5_000, 5)])
    key_dl = pool[np.asarray(ids) % len(pool)]
    hits = 1 + np.asarray(ids) % 3
    algo = np.isin(ids, leaky_keys).astype(np.int64)
    beh = np.where(np.asarray(ids) % 5 == 0, DRAIN, 0)
    cols = [hits, key_dl[:, 1], key_dl[:, 0], algo, beh,
            np.full(n, -1, np.int64), np.zeros(n, np.int64)]
    blob, offsets = teng_pack(keyset(ids))
    return (JReqColumns(blob, offsets, *[c.copy() for c in cols]),
            TReqColumns(blob, offsets, *[c.copy() for c in cols]))


def test_engine_herd_windows_take_the_grouped_plan_like_jax():
    rng = np.random.default_rng(10)
    jeng_, teng_ = jax_engine(CAP), TickEngine(capacity=CAP, max_batch=B,
                                               device="cpu")
    # Leaky keys use rates (250 and 1000 ms) that divide the windows'
    # spacing, so every leak is exact.
    leaky = [k for k in range(40) if k % 4 in (2, 3) and k % 3 == 0]
    wins = []
    now = NOW
    for k in range(5):
        now += int(rng.integers(0, 3)) * 1_000
        ids = (rng.zipf(1.3, B) - 1) % 40
        wins.append((*herd_columns(rng, ids, now, leaky), now))
    run_windows(jeng_, teng_, wins)
    assert teng_.metric_grouped_ticks == len(wins)
    assert teng_.metric_rank_rounds == teng_.metric_layered_ticks == 0


def test_engine_layered_windows_take_the_layered_plan_like_jax():
    rng = np.random.default_rng(11)
    jeng_, teng_ = jax_engine(LCAP), TickEngine(capacity=LCAP, max_batch=B,
                                                device="cpu")
    wins = []
    now = NOW
    for k in range(2):
        now += 1_000
        ids = 1 + (rng.zipf(1.3, B) - 1) % 30
        ids[:12] = 0
        jc, tc = herd_columns(rng, ids, now, leaky_keys=[2, 3, 6])
        # Key 0 breaks into four units: a RESET row and a hits change.
        for c in (jc, tc):
            c.behavior[4] = RESET
            c.hits[9:12] = 2
        wins.append((jc, tc, now))
    run_windows(jeng_, teng_, wins)
    assert teng_.metric_layered_ticks == jeng_.metric_layered_ticks == 2
    assert teng_.metric_rank_rounds == teng_.metric_grouped_ticks == 0
