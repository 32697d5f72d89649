"""The port's chained duplicate tick against the JAX package's x64 oracle.

* The plain version (``fused_sorted_tick`` on CPU tensors: rank rounds of
  the fused tick's plain version) against the reference's x64 oracle
  ``engine._jitted_tick(1 << 10, "columns", sorted_input=True,
  compact_resp=True, compact_req=True)`` at B = 256 (the program
  ``tests/test_sorted32.py`` compiles): duplicate windows with random
  per-request parameters over all five algorithms (RESET, DRAIN,
  Gregorian and query lanes, runs of identical requests that the oracle
  folds in closed form), error and padding lanes, chained over ticks;
  and the inexact-leak sequence of ROADMAP C.1, where the JAX engine's
  parts programs answer otherwise.  Responses and the whole logical
  table must be exact.
* The CUDA kernel's blocks (``csrc/sorted_tick.cuh``), compiled for the
  host, against the plain version bit for bit at 1-4096 lanes: Zipf
  windows, windows of one segment as long as the window, EDGE windows,
  inert lanes inside a segment; and at the kernel's chunk shapes
  (``tests/test_torch_cuda.py`` CHAIN_CASES: segments around one and two
  chunks of lanes, a long segment that switches algorithm and flags,
  inert long segments, padding after a long segment, a column slice).  The kernel itself runs only on the card
  (tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gubernator_tpu.ops.buckets import BucketState, logical_view, stored_view
from gubernator_tpu.ops.engine import _jitted_tick
from gubernator_tpu_torch import _build
from gubernator_tpu_torch.carry import columns_from_table, table_from_columns
from gubernator_tpu_torch.ops.buckets import STATE_FIELDS, zeros_table
from gubernator_tpu_torch.ops.sortedtick import (
    CONFIG_KEYS, fused_sorted_tick, fused_sorted_tick_plain)
from gubernator_tpu_torch.types import Algorithm
from tests.test_torch_common import NOW, gen_lanes, pack_m32
from tests.test_torch_cuda import (
    SORTED_CASES, SORTED_IDS, SORTED_KINDS, case_lanes, sorted_window_case)
from tests.test_torch_fusedtick import assert_tables_equal, jax_logical

CAP = 1 << 10
B = 256
ORACLE = _jitted_tick(CAP, "columns", sorted_input=True, compact_resp=True,
                      compact_req=True)
PARAMS = ("hits", "limit", "duration", "algorithm", "behavior",
          "created_at", "burst", "greg_exp", "greg_dur")


def oracle_tick(state, m, now):
    state, resp = ORACLE(state, jnp.asarray(m), jnp.int64(now))
    return state, np.asarray(resp)


def oracle_columns(state):
    lv = logical_view(state)
    return {f: np.asarray(getattr(lv, f)) for f in STATE_FIELDS}


def dup_window(rng, errors=3):
    """A slot-sorted (19, B) window of n live lanes whose slots repeat (a
    hot slot and random collisions), random requests over all five
    algorithms with runs of identical duplicates, then ``errors``
    per-item error lanes and padding (valid == 0, slot == CAP).  Returns
    ``(m, n + errors)``."""
    n = int(rng.integers(120, B - errors))
    hot = int(rng.integers(5, 40))
    slots = np.sort(np.concatenate([
        np.full(hot, rng.integers(0, CAP)),
        rng.integers(0, CAP // 8, n - hot)]))
    _, req = gen_lanes(rng, n)
    for i in range(1, n):
        if slots[i] == slots[i - 1] and rng.random() < 0.6:
            for f in PARAMS:
                req[f][i] = req[f][i - 1]
    return pack_m32(req, slots, B, CAP), n + errors


@pytest.mark.parametrize("seed", [41, 42])
def test_plain_sorted_tick_matches_x64_oracle(seed):
    rng = np.random.default_rng(seed)
    state_cols, _ = gen_lanes(rng, CAP)
    jstate = stored_view(jax_logical(state_cols))
    table = table_from_columns(state_cols, CAP, "cpu")
    rounds = fused_sorted_tick_plain.rounds
    for t in range(3):
        m, k = dup_window(rng)
        now = NOW + 1_000 * t
        jstate, want = oracle_tick(jstate, m, now)
        got = fused_sorted_tick(table, torch.from_numpy(m), now)
        np.testing.assert_array_equal(got.numpy()[:, :k], want[:, :k],
                                      err_msg=f"tick {t}")
        assert (got.numpy()[:, k - 3:] == 0).all()
        assert_tables_equal(columns_from_table(table), oracle_columns(jstate))
    assert fused_sorted_tick_plain.rounds - rounds > 3 * 5
    assert (table[CAP] == 0).all()


def test_inexact_leak_sequence_follows_x64_oracle():
    """ROADMAP C.1: a leaky key (limit 10, duration 30000, burst 10) takes
    hits 8 at t0, 0 at t0 + 8545, then 0 and 1 at t0 + 12000 in one
    window.  float64 leaks (2 + 8545/3000) + 3455/3000 = 5.999999999999999,
    so the x64 oracle and the port answer 5 (reset t0 + 27000) then 4
    (reset t0 + 30000); the JAX engine's triple-float32 programs answer 6
    then 5."""
    t0 = NOW
    jstate = jax.tree.map(jnp.asarray, BucketState.zeros(CAP))
    table = zeros_table(CAP, "cpu")
    answers = []
    for now, hits in ((t0, [8]), (t0 + 8_545, [0]), (t0 + 12_000, [0, 1])):
        n = len(hits)
        req = {f: np.zeros(n, np.int64) for f in PARAMS}
        req.update(hits=np.array(hits), limit=np.full(n, 10),
                   duration=np.full(n, 30_000), burst=np.full(n, 10),
                   algorithm=np.full(n, int(Algorithm.LEAKY_BUCKET)),
                   created_at=np.full(n, now), known=np.full(n, now > t0),
                   valid=np.ones(n, bool))
        m = pack_m32(req, np.full(n, 7), B, CAP)
        jstate, want = oracle_tick(jstate, m, now)
        got = fused_sorted_tick(table, torch.from_numpy(m), now).numpy()
        np.testing.assert_array_equal(got[:, :n], want[:, :n])
        answers.append(got[:, :n])
    last = answers[-1].astype(np.int64)
    remaining = last[2] | (last[3] << 32)
    reset = (last[4] & 0xFFFFFFFF) | (last[5] << 32)
    assert remaining.tolist() == [5, 4]
    assert (reset - t0).tolist() == [27_000, 30_000]
    assert_tables_equal(columns_from_table(table), oracle_columns(jstate))


def _host_lib():
    lib = _build.load("fused_tick_host")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gt_fused_sorted_tick_host.restype = ctypes.c_int
    lib.gt_fused_sorted_tick_host.argtypes = [vp, i64, vp, i64, vp, i64, i64,
                                              i64]
    lib.gt_fused_sorted_tick_config_host.restype = ctypes.c_int
    lib.gt_fused_sorted_tick_config_host.argtypes = [vp]
    return lib


def host_chunk() -> int:
    """The host build's chunk (csrc/sorted_tick.cuh CHUNK)."""
    out = (ctypes.c_int64 * len(CONFIG_KEYS))()
    assert _host_lib().gt_fused_sorted_tick_config_host(out) == 0
    return dict(zip(CONFIG_KEYS, out))["chunk"]


@pytest.mark.parametrize("kind,width", SORTED_CASES, ids=SORTED_IDS)
def test_sorted_lane_code_on_host_matches_plain(kind, width):
    """The host build of the kernel's blocks (long blocks walking chunks,
    lane blocks' short segments) against rank rounds, bit for bit; the
    window is ``m[:, cols]``, a column slice for the "slice" case."""
    chunk = host_chunk()
    state, m, cols = sorted_window_case(kind, width, chunk)
    t_plain = table_from_columns(state, 1024, "cpu")
    t_host = t_plain.clone()
    mt = torch.from_numpy(m)[:, cols]
    lanes = mt.shape[1]
    rounds = fused_sorted_tick_plain.rounds
    r_plain = fused_sorted_tick_plain(
        t_plain, mt.contiguous(), NOW,
        torch.empty((6, lanes), dtype=torch.int32))
    r_host = torch.full((6, lanes), -7, dtype=torch.int32)
    rc = _host_lib().gt_fused_sorted_tick_host(
        t_host.data_ptr(), 1024, mt.data_ptr(), mt.stride(0),
        r_host.data_ptr(), r_host.stride(0), lanes, NOW)
    assert rc == 0
    assert torch.equal(r_host, r_plain)
    assert torch.equal(t_host, t_plain)
    if kind == "one":
        assert fused_sorted_tick_plain.rounds - rounds == width
    if kind not in SORTED_KINDS:
        assert (fused_sorted_tick_plain.rounds - rounds
                >= case_lanes(width, chunk))
