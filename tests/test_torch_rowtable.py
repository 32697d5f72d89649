"""The port's row table (gubernator_tpu_torch/ops/rowtable.py) against the
JAX package's row-layout helpers.

The plain ``gather_rows`` / ``scatter_rows`` / ``row_evict`` (the CPU path
of each wrapper) are held against ``rowtable.row_gather_state`` /
``row_scatter_state`` / ``row_evict``, whose Pallas kernels run in
interpret mode here (skipped where this jax build cannot lower them), on
one table carried into both packages.  Both sides are compared as logical
columns, exactly: ``remaining_f`` bit for bit.  The dead-slot scan is held
against the JAX package's row-layout TTL sweep, and the carry functions
against themselves.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gubernator_tpu.ops import rowtable as jrow
from gubernator_tpu.ops.buckets import BucketState
import gubernator_tpu_torch as gt
from gubernator_tpu_torch.carry import columns_from_table, table_from_columns
from gubernator_tpu_torch.ops import rowtable
from gubernator_tpu_torch.ops.buckets import (
    ROW_W, STATE_FIELDS, logical_to_rows, rows_to_logical)
from tests.test_torch_common import NOW, gen_lanes, to_torch

CAP = 64
_I32 = ("algorithm", "status")


def _state(seed, n=CAP):
    state, _ = gen_lanes(np.random.default_rng(seed), n)
    return state


def _jax_logical(cols):
    return BucketState(**{
        f: jnp.asarray(cols[f], jnp.int32 if f in _I32 else None)
        for f in STATE_FIELDS
    })


def _jax_table(cols):
    mat = jrow.logical_to_matrix(_jax_logical(cols))
    return jrow.RowState(table=jnp.concatenate(
        [mat, jnp.zeros((1, jrow.ROW_W), jnp.int32)]))


def _jax_columns(table, cap=CAP):
    jl = jrow.matrix_to_logical(table[:cap])
    return {f: np.asarray(getattr(jl, f)) for f in STATE_FIELDS}


def _assert_columns_equal(got, want):
    for f in STATE_FIELDS:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        if f == "remaining_f":
            np.testing.assert_array_equal(
                g.astype(np.float64).view(np.int64),
                w.astype(np.float64).view(np.int64), err_msg=f)
        else:
            np.testing.assert_array_equal(
                g.astype(np.int64), w.astype(np.int64), err_msg=f)


@pytest.fixture
def interpret():
    if not jrow.interpret_supported():
        pytest.skip("Pallas interpret mode cannot lower the row kernels on "
                    "this jax build")


@pytest.mark.parametrize("seed", [1, 2])
def test_gather_rows_matches_row_gather_state(interpret, seed):
    cols = _state(seed)
    rng = np.random.default_rng(seed + 100)
    # Real slots (repeats allowed for a gather) plus the guard row.
    slots = rng.integers(0, CAP + 1, 48).astype(np.int64)
    slots[::7] = CAP
    want = jax.jit(jrow.row_gather_state)(
        _jax_table(cols), jnp.asarray(slots, jnp.int32))
    table = table_from_columns(cols, CAP, "cpu")
    got = rows_to_logical(rowtable.gather_rows(table, torch.from_numpy(slots)))
    _assert_columns_equal({f: got[f].numpy() for f in STATE_FIELDS},
                          {f: np.asarray(getattr(want, f)) for f in STATE_FIELDS})


@pytest.mark.parametrize("seed", [3, 4])
def test_scatter_rows_matches_row_scatter_state(interpret, seed):
    cols = _state(seed)
    new, _ = gen_lanes(np.random.default_rng(seed + 200), 40)
    rng = np.random.default_rng(seed + 300)
    slots = rng.choice(CAP, 40, replace=False).astype(np.int64)
    slots[::9] = CAP  # guard-row lanes: harmless, never a real slot
    jstate = jax.jit(jrow.row_scatter_state)(
        _jax_table(cols), jnp.asarray(slots, jnp.int32), _jax_logical(new))
    table = table_from_columns(cols, CAP, "cpu")
    rows = logical_to_rows(to_torch(new))
    rowtable.scatter_rows(table, torch.from_numpy(slots), rows)
    _assert_columns_equal(columns_from_table(table), _jax_columns(jstate.table))
    assert (table[CAP] == 0).all()  # the port drops guard-row lanes


def test_row_evict_matches_jax(interpret):
    cols = _state(5)
    slots = np.array([0, 3, 17, 63, CAP, 40], np.int64)
    jstate = jax.jit(jrow.row_evict)(_jax_table(cols), jnp.asarray(slots))
    table = table_from_columns(cols, CAP, "cpu")
    rowtable.row_evict(table, torch.from_numpy(slots))
    _assert_columns_equal(columns_from_table(table), _jax_columns(jstate.table))
    assert (table[slots[slots < CAP]] == 0).all()


@pytest.mark.parametrize("now_offset", [-20_000, 0, 1, 70_000])
def test_dead_mask_matches_row_dead_scan(now_offset):
    """The reclaim's dead test (in_use == 0 or expire_at < now) agrees
    with the JAX package's row-layout TTL sweep over every slot."""
    cols = _state(6)
    now = NOW + now_offset
    want = jrow.row_device_dead_mask(_jax_table(cols), now, CAP)
    table = table_from_columns(cols, CAP, "cpu")
    got = rowtable.dead_mask(table, np.arange(CAP), now)
    np.testing.assert_array_equal(got, want)
    # A subset of candidates answers for exactly those slots.
    sub = np.array([5, 1, 60, 33])
    np.testing.assert_array_equal(rowtable.dead_mask(table, sub, now), want[sub])


def test_carry_round_trips_every_bit():
    cols = _state(7)
    cols["remaining_f"][:4] = [float("nan"), -0.0, float("inf"), -7.25]
    cols["limit"][4] = -(2**63)
    cols["expire_at"][5] = 2**63 - 1
    table = table_from_columns(cols, CAP + 3, "cpu")
    assert table.shape == (CAP + 4, ROW_W) and table.dtype == torch.int64
    back = columns_from_table(table)
    _assert_columns_equal({f: v[:CAP] for f, v in back.items()}, cols)
    assert all((v[CAP:] == 0).all() for v in back.values())
    assert back["algorithm"].dtype == np.int32 and back["in_use"].dtype == bool
    assert (table[:, len(STATE_FIELDS):] == 0).all()  # spare words


def test_wrappers_check_their_inputs():
    table = table_from_columns(_state(8), CAP, "cpu")
    with pytest.raises(ValueError):
        rowtable.gather_rows(table.to(torch.int32), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        rowtable.gather_rows(table, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        rowtable.scatter_rows(table, torch.zeros(4, dtype=torch.int64),
                              torch.zeros((4, ROW_W - 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        rowtable.gather_rows(table, torch.zeros((2, 2), dtype=torch.int64))


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    gt.reset_kernel_launches()
    table = table_from_columns(_state(9), CAP, "cpu")
    slots = torch.arange(0, CAP, 3, dtype=torch.int64)
    rows = rowtable.gather_rows(table, slots)
    rowtable.scatter_rows(table, slots, rows)
    rowtable.row_evict(table, slots[:2])
    assert gt.kernel_launches() == {
        "fused_tick": 0, "fused_merged_tick": 0, "fused_ragged_tick": 0,
        "fused_sorted_tick": 0, "mesh_tile_tick": 0, "gather_rows": 0,
        "scatter_rows": 0, "lease_apply": 0, "global_accumulate": 0,
        "global_dense_reconcile": 0, "global_sparse_probe": 0,
        "global_sparse_apply": 0}
