"""The mesh engine's duplicate path against the JAX package's x64 programs.

* ``raggedtick.ragged_walk`` over ``tick.merge_tick`` against the JAX
  ``ragged_walk`` over ``engine.make_tick_fn(L, compact_req=True,
  compact_resp=True)``, the tile tick the JAX mesh engine runs on windows
  whose slots repeat: one shard's extent of a flat global-slot window,
  walked in 16-lane tiles, with herds split across a tile boundary,
  RESET_REMAINING rows, mixed-parameter groups, followers of heads that
  come out expired and a tile clamped at the batch end.  The (6, B)
  responses and the shard's logical state must be exact.
* ``transition.merged_formulas`` against ``engine._merged_formulas`` on the
  three kinds of lane where the x64 fold parts from the parts fold
  (``merged_fold``) that the single-card engine's plans follow.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gubernator_tpu.ops.buckets import RespBatch, np_logical, stored_view
from gubernator_tpu.ops.engine import _merged_formulas, make_tick_fn
from gubernator_tpu.ops.raggedtick import ragged_walk as jax_ragged_walk
from gubernator_tpu_torch.carry import columns_from_table, table_from_columns
from gubernator_tpu_torch.ops import engine as teng
from gubernator_tpu_torch.ops import tick
from gubernator_tpu_torch.ops.buckets import STATE_FIELDS
from gubernator_tpu_torch.ops.raggedtick import ragged_walk, shard_block
from gubernator_tpu_torch.ops.transition import merged_fold, merged_formulas
from gubernator_tpu_torch.types import Behavior
from tests.test_torch_common import NOW, gen_lanes, pack_m32, to_jax, to_torch
from tests.test_torch_fusedtick import assert_tables_equal, jax_logical

L = 32       # local capacity; the window's extent belongs to shard 1
B, TILE = 64, 16
R = teng.REQ32_INDEX
RESET = int(Behavior.RESET_REMAINING)


@pytest.fixture(scope="module")
def jax_walk():
    """The JAX mesh engine's duplicate program for one shard: the extent
    walk over the x64 merge tick, compiled once (extent and now are
    runtime values)."""
    tile_tick = make_tick_fn(L, compact_req=True, compact_resp=True)

    @jax.jit
    def walk(state, m, start, count, lo, now):
        return jax_ragged_walk(
            lambda s, blk: tile_tick(s, blk, now), state, m, start, count,
            lo, L, TILE, jnp.zeros((6, B), jnp.int32))

    def run(cols, m, start, count, now):
        st, resp = walk(stored_view(jax_logical(cols)), jnp.asarray(m),
                        jnp.int32(start), jnp.int32(count), jnp.int32(L),
                        jnp.int64(now))
        return ({f: np_logical(getattr(st, f), f) for f in STATE_FIELDS},
                np.asarray(resp))

    return run


def dup_lanes(rng, count, now, exact):
    """``count`` slot-sorted lanes on shard 1 (global slots) whose slots
    repeat: most groups are herds of identical eligible requests (token or
    leaky, hits > 0, known), some are broken by RESET rows or a changed
    parameter, and created_at ranges over now and the past, so some heads
    come out expired and some followers fold only once the device has
    checked their head."""
    _, req = gen_lanes(rng, count, exact=exact)
    slots = np.sort(rng.integers(0, L // 2, count))
    starts = np.flatnonzero(np.r_[count > 0, slots[1:] != slots[:-1]])
    ends = np.r_[starts[1:], count]
    for a, z in zip(starts, ends):
        kind = rng.random()
        if kind < 0.7:            # a herd (kind < 0.15: a broken one)
            for f in ("hits", "limit", "duration", "algorithm", "behavior",
                      "created_at", "burst"):
                req[f][a:z] = req[f][a]
            req["algorithm"][a:z] = rng.integers(0, 2)
            req["hits"][a:z] = rng.choice([1, 2, 3])
            req["behavior"][a:z] &= ~(RESET | int(
                Behavior.DURATION_IS_GREGORIAN))
            req["created_at"][a:z] = now - rng.choice([0, 0, 500, 90_000])
            req["known"][a + 1:z] = True
            if kind < 0.15 and z - a > 2:
                j = rng.integers(a + 1, z)
                if rng.random() < 0.5:
                    req["behavior"][j] |= RESET
                else:
                    req["limit"][j] += 1
    return pack_m32(req, slots + L, count, 2 * L)


@pytest.mark.parametrize("seed,start,count,exact", [
    (1, 0, 64, True), (2, 3, 57, True), (3, 40, 24, False), (4, 50, 14, True),
    (5, 9, 0, True)])
def test_merge_tick_walk_matches_jax(jax_walk, seed, start, count, exact):
    rng = np.random.default_rng(seed)
    now = NOW + int(rng.integers(0, 5_000))
    cols = gen_lanes(rng, L, exact=exact)[0]
    m = np.zeros((teng.REQ32_ROWS, B), np.int32)
    m[R["slot"]] = 2 * L
    m[:, start:start + count] = dup_lanes(rng, count, now, exact)
    m[R["slot"], :start] = np.arange(start)          # shard 0's lanes
    m[R["valid"], :start] = 1

    jstate, jresp = jax_walk(cols, m, start, count, now)
    table = torch.cat([table_from_columns(gen_lanes(rng, L)[0], L, "cpu"),
                       table_from_columns(cols, L, "cpu")])
    other = table[:L + 1].clone()
    out = torch.zeros((6, B), dtype=torch.int32)
    rounds = []

    def tick_tile(block, blk):
        resp, r = tick.merge_tick(block, blk, now)
        rounds.append(r)
        return resp

    ragged_walk(tick_tile, shard_block(table, 1, L), m, start, count, L, L,
                TILE, out)
    np.testing.assert_array_equal(out.numpy(), jresp)
    assert_tables_equal(columns_from_table(shard_block(table, 1, L)), jstate)
    assert torch.equal(table[:L + 1], other)
    assert len(rounds) == -(-count // TILE)


def test_herd_split_across_a_tile_boundary_folds_per_tile(jax_walk):
    """One key's 20 identical requests straddle the first tile boundary:
    two tiles, each one head transition plus a closed-form fold, no rank
    rounds, and the JAX walk's answers."""
    rng = np.random.default_rng(8)
    now = NOW
    cols = gen_lanes(rng, L)[0]
    cols["in_use"][6] = False            # the herd's key is new
    _, req = gen_lanes(rng, 26)
    for f, v in (("hits", 1), ("limit", 100), ("duration", 60_000),
                 ("algorithm", 0), ("behavior", 0), ("created_at", now),
                 ("burst", 0), ("known", 1)):
        req[f][6:] = v
    m = np.zeros((teng.REQ32_ROWS, B), np.int32)
    m[R["slot"]] = 2 * L
    m[:, :26] = pack_m32(req, np.r_[np.arange(6), np.full(20, 6)] + L, 26,
                         2 * L)
    jstate, jresp = jax_walk(cols, m, 0, 26, now)
    table = torch.cat([table_from_columns(cols, L, "cpu")] * 2)
    out = torch.zeros((6, B), dtype=torch.int32)
    rounds = []

    def tick_tile(block, blk):
        resp, r = tick.merge_tick(block, blk, now)
        rounds.append(r)
        return resp

    ragged_walk(tick_tile, shard_block(table, 1, L), m, 0, 26, L, L, TILE,
                out)
    np.testing.assert_array_equal(out.numpy(), jresp)
    assert_tables_equal(columns_from_table(shard_block(table, 1, L)), jstate)
    assert rounds == [0, 0]
    rem = out.numpy()[2, 6:26]
    assert (np.diff(rem) == -1).all()   # one decrement per herd member


def _corner_lanes():
    """Three groups of a head and two followers at ranks 0-2, post-head
    state alive: a leaky head whose remaining_f is -2.5, a token head whose
    remaining is -7, and a leaky head whose duration / limit quotient is
    large and inexact in float64."""
    n = 9
    st = {f: np.zeros(n, np.float64 if f == "remaining_f" else np.int64)
          for f in STATE_FIELDS}
    st["in_use"] = np.ones(n, bool)
    st["expire_at"][:] = NOW + 60_000
    st["status"][:] = 0
    st["remaining_f"][:3] = -2.5
    st["remaining"][3:6] = -7
    st["remaining_f"][6:] = 9.75
    req = {f: np.zeros(n, np.int64) for f in (
        "slot", "known", "hits", "limit", "duration", "algorithm",
        "behavior", "created_at", "burst", "greg_exp", "greg_dur", "valid")}
    req["known"][:] = 1
    req["valid"][:] = 1
    req["algorithm"][:] = [1, 1, 1, 0, 0, 0, 1, 1, 1]
    req["hits"][:] = [1, 1, 1, 2, 2, 2, 1, 1, 1]
    req["limit"][:] = [10, 10, 10, 10, 10, 10, 3, 3, 3]
    req["duration"][:] = [30_000] * 6 + [2**60 + 1] * 3
    req["created_at"][:] = NOW
    req["slot"][:] = np.repeat(np.arange(3), 3)
    rank = np.tile(np.arange(3), 3)
    return st, req, rank


def test_merged_formulas_match_x64_on_the_corner_lanes():
    st, req, rank = _corner_lanes()
    head = np.repeat(np.arange(0, 9, 3), 3)
    last = np.full(9, 2)
    fold, head_mask = rank > 0, rank == 0
    js, jr = to_jax(st, req)
    jresp0 = RespBatch(status=jnp.zeros(9, jnp.int32),
                       limit=jnp.zeros(9, jnp.int64),
                       remaining=jnp.zeros(9, jnp.int64),
                       reset_time=jnp.zeros(9, jnp.int64),
                       over_limit=jnp.zeros(9, jnp.bool_))
    jrows, jresp, jmerged = jax.jit(_merged_formulas)(
        js, jresp0, jr, jnp.int64(NOW), jnp.asarray(rank), jnp.asarray(last),
        jnp.asarray(fold), jnp.asarray(head_mask),
        js.remaining[head], js.remaining_f[head], js.status[head],
        js.expire_at[head])

    ts, tr = to_torch(st), to_torch(req)
    zero = torch.zeros(9, dtype=torch.int64)
    rows, resp, merged = merged_formulas(
        ts, {"status": zero, "remaining": zero, "reset_time": zero,
             "over_limit": zero != 0}, tr, NOW, torch.from_numpy(rank),
        torch.from_numpy(last), torch.from_numpy(fold),
        torch.from_numpy(head_mask), ts["remaining"][head],
        ts["remaining_f"][head], ts["status"][head], ts["expire_at"][head])

    np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))
    for f in ("status", "remaining", "reset_time", "over_limit"):
        np.testing.assert_array_equal(
            resp[f].numpy().astype(np.int64),
            np.asarray(getattr(jresp, f)).astype(np.int64), err_msg=f)
    for f in STATE_FIELDS:
        want = np.asarray(getattr(jrows, f))
        got = rows[f].numpy()
        if f == "remaining_f":
            np.testing.assert_array_equal(got.view(np.int64),
                                          want.view(np.int64))
        else:
            np.testing.assert_array_equal(got.astype(np.int64),
                                          want.astype(np.int64), err_msg=f)
    # The x64 fold answers: leaky base trunc(-2.5) = -2 and q = -2 (the
    # followers answer OVER with 0 remaining); token q = -7 // 2 = -4
    # (followers answer the residue 1); rate_i the truncated float quotient.
    assert resp["remaining"].tolist()[1:3] == [0, 0]
    assert resp["remaining"].tolist()[4:6] == [1, 1]
    rate_x64 = int(np.float64(2**60 + 1) / np.float64(3))
    assert resp["reset_time"][7] == NOW + (3 - 8) * rate_x64

    # The parts fold of the single-card plans reads the same heads
    # differently: floor(-2.5) = -3, q clamped at 0, the exact integer
    # rate.  The mesh's duplicate path must not take it.
    _, parts = merged_fold(NOW, {k: v[head_mask] for k, v in ts.items()},
                           {k: v[head_mask] for k, v in tr.items()},
                           torch.full((3,), 3, dtype=torch.int32))
    assert parts["base"].tolist()[0] == -3
    assert parts["q"].tolist()[:2] == [0, 0]
    assert int(parts["rate_i"][2]) == (2**60 + 1) // 3 != rate_x64
