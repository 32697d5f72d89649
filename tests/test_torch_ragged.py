"""Kernel B.4, the ragged tick, against the JAX package.

* The plain version (``fused_ragged_tick`` on CPU tensors) against the
  JAX Pallas kernel ``raggedtick.make_fused_ragged_tick_fn`` in interpret
  mode, in the extent cases of ``tests/test_fusedtick.py`` (a full batch,
  an unaligned extent of an odd chunk count, a sub-chunk extent, an empty
  one) with other shards' live lanes on both sides, and on a 3-shard
  window that the JAX kernel ticks once per shard (summed, as the JAX
  mesh engine's psum gathers it).  The interpret program is compiled
  once for all of them (~50 s of this file's time, cold).
* The CUDA kernel's lane code (``csrc/transition.cuh`` ``ragged_row`` and
  the transition) and its tile steps (``csrc/tile.cuh``), compiled for the
  host, against the plain version, also at the tile shapes.
* ``choose_tile``, ``RaggedExtents`` and the native ``crc32_batch``
  against the JAX package and ``zlib``.
"""

import ctypes
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gubernator_tpu.ops import rowtable as jrow
from gubernator_tpu.ops.raggedtick import choose_tile as jax_choose_tile
from gubernator_tpu.ops.raggedtick import make_fused_ragged_tick_fn
from gubernator_tpu.parallel.partition import RaggedExtents as JaxExtents
import gubernator_tpu_torch as gt
from gubernator_tpu_torch import _build
from gubernator_tpu_torch.carry import (
    columns_from_table, sharded_table_from_columns, table_from_columns)
from gubernator_tpu_torch.native import crc32_batch
from gubernator_tpu_torch.ops import engine as teng
from gubernator_tpu_torch.ops.buckets import STATE_FIELDS
from gubernator_tpu_torch.ops.raggedtick import (
    choose_tile, fused_ragged_tick, fused_ragged_tick_plain, shard_block)
from gubernator_tpu_torch.ops.reqcols import pack_blob
from gubernator_tpu_torch.parallel.partition import RaggedExtents
from tests.test_torch_common import NOW, edge_lanes, gen_lanes, pack_m32
from tests.test_torch_cuda import ragged_case
from tests.test_torch_fusedtick import assert_tables_equal, jax_logical

L = 16          # local capacity of each shard
N_SHARDS = 3
B, CHUNK = 8, 2
R = teng.REQ32_INDEX
CASES = {"full": (0, 8), "odd": (1, 5), "tiny": (3, 1), "empty": (4, 0)}


@pytest.fixture(scope="module")
def ragged():
    """The JAX Pallas ragged kernel, one compiled program for every case
    (start, count and lo are runtime scalars)."""
    if not jrow.interpret_supported():
        pytest.skip("Pallas interpret mode cannot lower the row kernels on "
                    "this jax build")
    fn = jax.jit(make_fused_ragged_tick_fn(L, chunk=CHUNK))

    def run(cols, m, start, count, lo):
        mat = jrow.logical_to_matrix(jax_logical(cols))
        table = jnp.concatenate([mat, jnp.zeros((1, jrow.ROW_W), jnp.int32)])
        st, resp = fn(jrow.RowState(table=table), jnp.asarray(m),
                      np.int32(start), np.int32(count), np.int32(lo),
                      jnp.int64(NOW))
        logical = jrow.matrix_to_logical(st.table[:L])
        return ({f: np.asarray(getattr(logical, f)) for f in STATE_FIELDS},
                np.asarray(resp))

    return run


def shard_states(rng):
    """Random logical state of every slot of every shard."""
    return [gen_lanes(rng, L)[0] for _ in range(N_SHARDS)]


def sharded_table(states):
    return torch.cat([table_from_columns(c, L, "cpu") for c in states])


def extent_lanes(rng, shard, count):
    """A sorted unique run of ``count`` live lanes on ``shard``'s slots
    (global slot numbers), request fields from the exact pool."""
    _, req = gen_lanes(rng, count)
    slots = np.sort(rng.choice(L, count, replace=False)) + shard * L
    return pack_m32(req, slots, count, N_SHARDS * L)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_kernel_in_interpret_mode(ragged, case):
    """Shard 1's extent [start, start + count) of a flat global-slot window
    whose other lanes are live lanes of shards 0 and 2: the port, given
    offsets that make every other lane off every extent, ticks exactly
    what the JAX kernel does for shard 1, answers zeros elsewhere and
    leaves the other shards' blocks alone."""
    start, count = CASES[case]
    rng = np.random.default_rng(40 + start)
    states = shard_states(rng)
    m = np.zeros((teng.REQ32_ROWS, B), np.int32)
    m[R["slot"]] = N_SHARDS * L
    m[:, :start] = extent_lanes(rng, 0, start)
    m[:, start:start + count] = extent_lanes(rng, 1, count)
    m[:, start + count:] = extent_lanes(rng, 2, B - start - count)

    jstate, jresp = ragged(states[1], m, start, count, L)
    table = sharded_table(states)
    before = table.clone()
    offsets = torch.tensor([start, start, start + count, start + count],
                           dtype=torch.int32)
    resp = fused_ragged_tick(table, torch.from_numpy(m), offsets, N_SHARDS,
                             L, NOW).numpy()

    ext = slice(start, start + count)
    np.testing.assert_array_equal(resp[:, ext], jresp[:, ext])
    off = np.ones(B, bool)
    off[ext] = False
    assert (resp[:, off] == 0).all() and (jresp[:, off] == 0).all()
    assert_tables_equal(columns_from_table(shard_block(table, 1, L)), jstate)
    for s in (0, 2):
        assert torch.equal(shard_block(table, s, L), shard_block(before, s, L))
    assert (table[L::L + 1] == 0).all()  # guard rows are never written


def test_three_shard_window_matches_summed_pallas_kernel(ragged):
    """One port call over three extents equals the JAX kernel run once per
    shard on its own table, responses summed (the mesh's psum)."""
    rng = np.random.default_rng(44)
    states = shard_states(rng)
    offs = [0, 3, 5, 8]
    m = np.concatenate([extent_lanes(rng, s, offs[s + 1] - offs[s])
                        for s in range(N_SHARDS)], axis=1)
    table = sharded_table(states)
    resp = fused_ragged_tick(table, torch.from_numpy(m),
                             torch.tensor(offs, dtype=torch.int32), N_SHARDS,
                             L, NOW).numpy()
    total = np.zeros((6, B), np.int64)
    for s in range(N_SHARDS):
        jstate, jresp = ragged(states[s], m, offs[s], offs[s + 1] - offs[s],
                               s * L)
        total += jresp
        assert_tables_equal(columns_from_table(shard_block(table, s, L)),
                            jstate)
    np.testing.assert_array_equal(resp, total)


def _host_kernel():
    lib = _build.load("fused_tick_host")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gt_fused_ragged_tick_host.restype = ctypes.c_int
    lib.gt_fused_ragged_tick_host.argtypes = [
        vp, i64, i64, vp, vp, i64, vp, i64, i64, i64]
    return lib


@pytest.mark.parametrize("seed,exact", [(1, True), (2, False)])
def test_kernel_lane_code_on_host_matches_plain(seed, exact):
    """Empty shards, lanes off every extent on both sides, a valid == 0
    lane and a slot outside its shard inside an extent, edge lanes: the
    host build of the kernel's lane loop equals the plain version."""
    rng = np.random.default_rng(seed)
    n, cap = 5, 64
    states = [gen_lanes(rng, cap, exact=exact)[0] for _ in range(n)]
    es, er = edge_lanes()
    for f in STATE_FIELDS:       # edge state in shard 3's first slots
        states[3][f][:len(er["hits"])] = es[f]
    counts = [10, 0, 25, len(er["hits"]), 0]
    parts = [np.zeros((teng.REQ32_ROWS, 3), np.int32)]   # before offsets[0]
    for s, c in enumerate(counts):
        if s == 3:
            parts.append(pack_m32(er, np.arange(c) + s * cap, c, n * cap))
            continue
        _, req = gen_lanes(rng, c, exact=exact)
        slots = np.sort(rng.choice(cap, c, replace=False)) + s * cap
        parts.append(pack_m32(req, slots, c, n * cap))
    parts.append(np.zeros((teng.REQ32_ROWS, 7), np.int32))  # padding
    m = np.concatenate(parts, axis=1)
    m[R["slot"], :3] = 5                      # another shard's lanes
    m[R["valid"], :3] = 1
    m[R["valid"], 5] = 0                      # inert lane in shard 0
    m[R["slot"], 20] = 3 * cap + 1            # a slot outside shard 2
    offsets = np.concatenate([[3], 3 + np.cumsum(counts)]).astype(np.int32)

    t_plain = torch.cat([table_from_columns(c, cap, "cpu") for c in states])
    t_host = t_plain.clone()
    mt = torch.from_numpy(m)
    r_plain = fused_ragged_tick_plain(
        t_plain, mt, torch.from_numpy(offsets), n, cap, NOW,
        torch.empty((6, m.shape[1]), dtype=torch.int32))
    r_host = torch.full((6, m.shape[1]), -7, dtype=torch.int32)
    rc = _host_kernel().gt_fused_ragged_tick_host(
        t_host.data_ptr(), n, cap, offsets.ctypes.data, mt.data_ptr(),
        mt.stride(0), r_host.data_ptr(), r_host.stride(0), m.shape[1], NOW)
    assert rc == 0
    assert torch.equal(r_host, r_plain)
    assert torch.equal(t_host, t_plain)
    assert (r_plain[:, :3] == 0).all() and (r_plain[:, -7:] == 0).all()
    assert (r_plain[:, [5, 20]] == 0).all()
    assert (t_plain[cap::cap + 1] == 0).all()


@pytest.mark.parametrize("width", (1, 8, 9, 64, 65, 257))
@pytest.mark.parametrize("kind", ("balanced", "skewed", "edge"))
def test_tile_code_on_host_matches_plain(kind, width):
    """The host build of the ragged kernel's tile steps at the tile shapes,
    narrow windows as column slices of wider ones (offsets clipped)."""
    state, m, offs = ragged_case(kind, width, seed=width)
    t_plain = sharded_table_from_columns(state, 3, 512, "cpu")
    t_host = t_plain.clone()
    mt = torch.from_numpy(m)[:, :width]
    r_plain = fused_ragged_tick_plain(
        t_plain, mt, torch.from_numpy(offs), 3, 512, NOW,
        torch.empty((6, width), dtype=torch.int32))
    r_host = torch.full((6, width), -7, dtype=torch.int32)
    rc = _host_kernel().gt_fused_ragged_tick_host(
        t_host.data_ptr(), 3, 512, offs.ctypes.data, mt.data_ptr(),
        mt.stride(0), r_host.data_ptr(), r_host.stride(0), width, NOW)
    assert rc == 0
    assert torch.equal(r_host, r_plain)
    assert torch.equal(t_host, t_plain)


def test_wrapper_checks_and_cpu_launches_nothing():
    gt.reset_kernel_launches()
    table = torch.zeros((2 * (L + 1), 16), dtype=torch.int64)
    m = torch.zeros((19, 4), dtype=torch.int32)
    off = torch.zeros(3, dtype=torch.int32)
    fused_ragged_tick(table, m, off, 2, L, NOW)
    assert gt.kernel_launches()["fused_ragged_tick"] == 0
    with pytest.raises(ValueError):
        fused_ragged_tick(table, m, off, 3, L, NOW)        # wrong row count
    with pytest.raises(ValueError):
        fused_ragged_tick(table, m, off[:2], 2, L, NOW)    # short offsets
    with pytest.raises(ValueError):
        fused_ragged_tick(table, m, off.long(), 2, L, NOW)
    with pytest.raises(ValueError):
        fused_ragged_tick(table, m.t().contiguous().t(), off, 2, L, NOW)


@pytest.mark.parametrize("b", [1, 63, 64, 100, 1024, 32768])
def test_choose_tile_matches_jax(b):
    for n in (1, 3, 4, 8, 100):
        assert choose_tile(b, n) == jax_choose_tile(b, n)


def test_ragged_extents_match_jax():
    rng = np.random.default_rng(5)
    for n in (1, 4, 8):
        sh = rng.integers(0, n, 200)
        ok = rng.random(200) < 0.8
        mine, ref = RaggedExtents(n, 32), JaxExtents(n, 32)
        np.testing.assert_array_equal(mine.counts(sh, ok), ref.counts(sh, ok))
        np.testing.assert_array_equal(mine.offsets(mine.counts(sh, ok)),
                                      ref.offsets(ref.counts(sh, ok)))
        assert mine.offsets(mine.counts(sh, ok)).dtype == np.int32
        np.testing.assert_array_equal(mine.counts(sh, ok & False),
                                      np.zeros(n))


def test_crc32_batch_matches_zlib_and_jax():
    from gubernator_tpu.native import crc32_batch as jax_crc32

    rng = np.random.default_rng(6)
    keys = [b"", b"a", "ключ".encode()] + [
        rng.integers(0, 256, int(k)).astype(np.uint8).tobytes()
        for k in rng.integers(0, 80, 300)]
    blob, offsets = pack_blob(keys)
    got = crc32_batch(blob, offsets)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, [zlib.crc32(k) for k in keys])
    np.testing.assert_array_equal(got, jax_crc32(blob, offsets))
