"""The port's plain transition (gubernator_tpu_torch/ops/transition.py)
against the JAX package's x64 ``bucket_transition`` and the scalar zoo
references.

Both sides run the same float64 formula in the same operation order, so
every output is held EXACTLY equal, ``remaining_f`` included (compared
bit for bit, so -0.0 and NaN payloads count too), on random lanes over
all five algorithms with exact and inexact leaky rates, and on edge lanes
whose float64 → int64 conversions leave the int64 range and whose int64
products overflow.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gubernator_tpu.algos import reference
from gubernator_tpu.ops.buckets import bucket_transition as jax_transition
from gubernator_tpu_torch.ops.buckets import STATE_FIELDS
from gubernator_tpu_torch.ops.transition import bucket_transition, trunc_i64
from tests.test_torch_common import (
    NOW, edge_lanes, gen_lanes, to_jax, to_torch)

_jitted = jax.jit(jax_transition)


def _assert_same(state, req):
    want_s, want_r = _jitted(jnp.int64(NOW), *to_jax(state, req))
    got_s, got_r = bucket_transition(NOW, to_torch(state), to_torch(req))
    for f in ("status", "remaining", "reset_time", "over_limit"):
        np.testing.assert_array_equal(
            got_r[f].numpy(), np.asarray(getattr(want_r, f)).astype(
                got_r[f].numpy().dtype), err_msg=f)
    for f in STATE_FIELDS:
        want = np.asarray(getattr(want_s, f))
        got = got_s[f].numpy()
        if f == "remaining_f":
            np.testing.assert_array_equal(
                got.view(np.int64), want.view(np.int64), err_msg=f)
        else:
            np.testing.assert_array_equal(got, want.astype(np.int64), err_msg=f)


@pytest.mark.parametrize("seed,exact", [(11, True), (12, True), (13, False),
                                        (14, False)])
def test_transition_matches_x64_oracle(seed, exact):
    state, req = gen_lanes(np.random.default_rng(seed), 2048, exact=exact)
    _assert_same(state, req)


def test_transition_edge_lanes_match_x64_oracle():
    state, req = edge_lanes()
    _assert_same(state, req)


def test_trunc_i64_saturates_like_xla():
    x = np.array([1e30, -1e30, np.nan, np.inf, -np.inf, 2.0**63, -2.0**63,
                  9.2e18, -9.2e18, 1.5, -1.5, -0.0, 2.0**63 - 1024])
    want = np.asarray(jax.jit(lambda a: a.astype(jnp.int64))(jnp.asarray(x)))
    np.testing.assert_array_equal(trunc_i64(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("seed", [21, 22])
def test_zoo_lanes_match_scalar_reference(seed):
    """Zoo lanes one at a time against algos/reference.py ``transition``."""
    rng = np.random.default_rng(seed)
    state, req = gen_lanes(rng, 400)
    zoo = np.flatnonzero(req["algorithm"] >= 2)
    greg = int(4)
    got_s, got_r = bucket_transition(NOW, to_torch(state), to_torch(req))
    checked = 0
    for i in zoo:
        if req["behavior"][i] & greg:
            continue  # the scalar references take no Gregorian inputs
        s = None
        if req["known"][i]:
            s = {f: state[f][i].item() for f in STATE_FIELDS}
        r = {f: int(req[f][i]) for f in ("hits", "limit", "duration",
                                          "algorithm", "behavior", "burst",
                                          "created_at")}
        ws, wr = reference.transition(s, r, NOW)
        assert int(got_r["status"][i]) == wr["status"], i
        assert int(got_r["remaining"][i]) == wr["remaining"], i
        assert int(got_r["reset_time"][i]) == wr["reset_time"], i
        assert bool(got_r["over_limit"][i]) == bool(wr["over_limit"]), i
        for f, v in ws.items():
            assert got_s[f][i].item() == v, (i, f)
        checked += 1
    assert checked > 50
