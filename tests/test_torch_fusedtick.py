"""The port's fused tick against the JAX package's tick programs.

* The plain version (``fused_tick`` on CPU tensors) against
  ``tick32.make_tick32_rows_fn(cap, "columns")`` on one carried table, one
  REQ32 matrix and one ``now``: live response lanes and the whole logical
  table must be exact.  The leaky (duration, limit) pairs come from the
  exact-quotient pool, because transition32 rounds its triple-float32
  remainder like float64 only there.
* The same against the fused Pallas kernel ``make_fused_tick_fn`` in
  interpret mode, where this jax build can run it.
* The CUDA kernel's lane code (``csrc/transition.cuh``) and its tile
  steps (``csrc/tile.cuh``: staging, class partition, per-class
  transition, write-back in lane order), compiled for the host, against
  the plain version bit for bit: inexact rates and edge lanes, windows of
  one lane, of the tile edges and of 255-257 lanes, mixed, of one
  algorithm each and of EDGE lanes only, and floor division's 32-bit
  fast path at its edges.  The kernel itself runs only on the card, where
  chip_smoke.py and tests/test_torch_cuda.py hold it against the plain
  version.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gubernator_tpu.ops import rowtable as jrow
from gubernator_tpu.ops.buckets import BucketState, np_logical, stored_view
from gubernator_tpu.ops.tick32 import make_tick32_rows_fn
from gubernator_tpu_torch import _build
from gubernator_tpu_torch.carry import columns_from_table, table_from_columns
from gubernator_tpu_torch.ops.buckets import STATE_FIELDS
from gubernator_tpu_torch.ops.fusedtick import fused_tick, fused_tick_plain
from tests.test_torch_common import NOW, edge_lanes, gen_lanes, pack_m32
from tests.test_torch_cuda import TILE_KINDS, TILE_WIDTHS, tick_case

CAP = 256
_I32 = ("algorithm", "status")


def table_cols(rng, cap, exact=True):
    """Random per-slot logical state (every slot populated)."""
    state, _ = gen_lanes(rng, cap, exact=exact)
    return state


def window(rng, n, b, cap, exact=True):
    """A slot-sorted unique window of n live lanes padded to b."""
    _, req = gen_lanes(rng, n, exact=exact)
    slots = np.sort(rng.choice(cap, n, replace=False)).astype(np.int64)
    return pack_m32(req, slots, b, cap)


def jax_logical(cols):
    return BucketState(**{
        f: jnp.asarray(cols[f], jnp.int32 if f in _I32 else None)
        for f in STATE_FIELDS
    })


def assert_tables_equal(got, want):
    for f in STATE_FIELDS:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        if f == "remaining_f":
            np.testing.assert_array_equal(g.view(np.int64), w.view(np.int64),
                                          err_msg=f)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=f)


@pytest.fixture(scope="module")
def tick32_columns():
    inner = jax.jit(make_tick32_rows_fn(CAP, "columns"))

    def run(state, m, now):
        s, rows = inner(state, jnp.asarray(m), jnp.int64(now))
        return s, np.stack([np.asarray(r) for r in rows])

    return run


@pytest.mark.parametrize("seed,n", [(1, 64), (2, 37), (3, 1)])
def test_plain_fused_tick_matches_tick32_columns(tick32_columns, seed, n):
    rng = np.random.default_rng(seed)
    cols = table_cols(rng, CAP)
    m = window(rng, n, 64, CAP)

    js, jresp = tick32_columns(stored_view(jax_logical(cols)), m, NOW)
    table = table_from_columns(cols, CAP, "cpu")
    resp = fused_tick(table, torch.from_numpy(m), NOW)

    np.testing.assert_array_equal(resp.numpy()[:, :n], jresp[:, :n])
    assert_tables_equal(
        columns_from_table(table),
        {f: np_logical(getattr(js, f), f) for f in STATE_FIELDS})
    assert (table[CAP] == 0).all()  # the guard row is never written


def test_plain_fused_tick_matches_pallas_kernel_in_interpret_mode():
    if not jrow.interpret_supported():
        pytest.skip("Pallas interpret mode cannot lower the row kernels on "
                    "this jax build")
    from gubernator_tpu.ops.fusedtick import make_fused_tick_fn

    rng = np.random.default_rng(5)
    cap, b, n = 64, 32, 27
    cols = table_cols(rng, cap)
    m = window(rng, n, b, cap)
    mat = jrow.logical_to_matrix(jax_logical(cols))
    jtable = jnp.concatenate([mat, jnp.zeros((1, jrow.ROW_W), jnp.int32)])
    fused = jax.jit(make_fused_tick_fn(cap, chunk=8))
    js, jresp = fused(jrow.RowState(table=jtable), jnp.asarray(m),
                      jnp.int64(NOW))

    table = table_from_columns(cols, cap, "cpu")
    resp = fused_tick(table, torch.from_numpy(m), NOW)
    np.testing.assert_array_equal(resp.numpy()[:, :n], np.asarray(jresp)[:, :n])
    jl = jrow.matrix_to_logical(js.table[:cap])
    assert_tables_equal(columns_from_table(table),
                        {f: np.asarray(getattr(jl, f)) for f in STATE_FIELDS})


def _host_kernel():
    lib = _build.load("fused_tick_host")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gt_fused_tick_host.restype = ctypes.c_int
    lib.gt_fused_tick_host.argtypes = [vp, i64, vp, i64, vp, i64, i64, i64]
    lib.gt_floor_divmod_host.restype = ctypes.c_int
    lib.gt_floor_divmod_host.argtypes = [vp, vp, i64, vp, vp]
    return lib


@pytest.mark.parametrize("seed,exact", [(7, True), (8, False)])
def test_kernel_lane_code_on_host_matches_plain(seed, exact):
    rng = np.random.default_rng(seed)
    cap, b, n = CAP, 256, 200
    cols = table_cols(rng, cap, exact=exact)
    m = window(rng, n, b, cap, exact=exact)
    # edge lanes: extreme values in fresh slots past the random ones
    es, er = edge_lanes()
    k = len(er["hits"])
    ecap = cap + k
    for f in STATE_FIELDS:
        cols[f] = np.concatenate([cols[f], es[f].astype(cols[f].dtype)])
    em = pack_m32(er, np.arange(cap, ecap), k, ecap)
    m[0][m[0] == cap] = ecap  # padding now aims at the wider guard row
    m = np.concatenate([m, em], axis=1)
    order = np.argsort(m[0], kind="stable")
    m = np.ascontiguousarray(m[:, order])

    t_plain = table_from_columns(cols, ecap, "cpu")
    t_host = t_plain.clone()
    mt = torch.from_numpy(m)
    r_plain = fused_tick_plain(t_plain, mt, NOW,
                               torch.empty((6, m.shape[1]), dtype=torch.int32))
    r_host = torch.full((6, m.shape[1]), -7, dtype=torch.int32)
    rc = _host_kernel().gt_fused_tick_host(
        t_host.data_ptr(), ecap, mt.data_ptr(), mt.stride(0),
        r_host.data_ptr(), r_host.stride(0), m.shape[1], NOW)
    assert rc == 0
    assert torch.equal(r_host, r_plain)
    assert torch.equal(t_host, t_plain)


def test_fused_tick_on_column_slices_matches_whole_window():
    """Rank rounds hand the kernel column slices of one wide matrix; a
    slice must act exactly like the same lanes as their own matrix."""
    rng = np.random.default_rng(9)
    cols = table_cols(rng, CAP)
    m = window(rng, 40, 64, CAP)
    t1 = table_from_columns(cols, CAP, "cpu")
    t2 = t1.clone()
    whole = fused_tick(t1, torch.from_numpy(m[:, 10:30].copy()), NOW)
    out = torch.zeros((6, 64), dtype=torch.int32)
    fused_tick(t2, torch.from_numpy(m)[:, 10:30], NOW, out=out[:, 10:30])
    assert torch.equal(out[:, 10:30], whole)
    assert torch.equal(t1, t2)


def host_tick(table, mt, now):
    """The host build of the fused tick kernel on ``table`` in place."""
    resp = torch.full((6, mt.shape[1]), -7, dtype=torch.int32)
    rc = _host_kernel().gt_fused_tick_host(
        table.data_ptr(), table.shape[0] - 1, mt.data_ptr(), mt.stride(0),
        resp.data_ptr(), resp.stride(0), mt.shape[1], now)
    assert rc == 0
    return resp


@pytest.mark.parametrize("width", TILE_WIDTHS)
@pytest.mark.parametrize("kind", TILE_KINDS)
def test_tile_code_on_host_matches_plain(kind, width):
    """The kernel's tile steps at the tile shapes: one lane, the direct
    path's edge (8 / 9 lanes), the 64-lane tile's edges, 255-257 lanes;
    narrow windows are column slices of wider ones (ld_m > B)."""
    state, m = tick_case(kind, width, seed=width)
    t_plain = table_from_columns(state, len(state["algorithm"]), "cpu")
    t_host = t_plain.clone()
    mt = torch.from_numpy(m)[:, :width]
    r_plain = fused_tick_plain(t_plain, mt, NOW,
                               torch.empty((6, width), dtype=torch.int32))
    assert torch.equal(host_tick(t_host, mt, NOW), r_plain)
    assert torch.equal(t_host, t_plain)


def test_floor_division_fast_path_matches_numpy():
    """transition.cuh floor_div / floor_mod against numpy's floor division
    around the 32-bit fast path's edges, negative dividends included."""
    edges = [0, 1, 2, 7, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 1,
             2**53, 2**63 - 1]
    a = np.array(edges + [-v for v in edges[1:]] + [-2**63], np.int64)
    b = np.array([1, 2, 3, 7, 2**31 - 1, 2**31, 2**32 - 1, 2**32,
                  2**32 + 1, 2**62], np.int64)
    aa, bb = (np.ascontiguousarray(x.ravel()) for x in np.meshgrid(a, b))
    q, r = np.empty_like(aa), np.empty_like(aa)
    rc = _host_kernel().gt_floor_divmod_host(
        aa.ctypes.data, bb.ctypes.data, aa.size, q.ctypes.data, r.ctypes.data)
    assert rc == 0
    np.testing.assert_array_equal(q, np.floor_divide(aa, bb))
    np.testing.assert_array_equal(r, np.mod(aa, bb))


def test_launches_counted_by_power_of_two_width():
    import gubernator_tpu_torch as gt
    from gubernator_tpu_torch.ops.fusedtick import count_launch, width_bucket

    assert [width_bucket(w) for w in (1, 2, 3, 4, 5, 64, 65, 32768)] == [
        1, 2, 4, 4, 8, 64, 128, 32768]
    gt.reset_kernel_launches()
    for w in (3, 4, 65):
        count_launch(fused_tick, w)
    assert gt.kernel_launches()["fused_tick"] == 3
    assert gt.kernel_launches_by_width()["fused_tick"] == {4: 2, 128: 1}
    gt.reset_kernel_launches()
    assert gt.kernel_launches_by_width() == {
        "fused_tick": {}, "fused_merged_tick": {}, "fused_ragged_tick": {}}
