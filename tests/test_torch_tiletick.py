"""The mesh's duplicate tile tick (kernel B.6) on the CPU.

The host build of the kernel's lane code (``gt_mesh_tile_tick_host`` in
``csrc/fused_tick_host.cc``: the same ``csrc/mesh_tile_tick.cuh`` warp and
block steps the kernel runs, each lane block's warps and then the run
blocks, with a warp's lanes and a block's threads held in arrays) against
the plain version
(``ops/tiletick.mesh_tile_tick_plain``: the tile walk of each shard's
extent through ``tick.merge_tick``), bit for bit: responses, table and
rank rounds, on ``chip_smoke.tile_window``'s kinds at widths whose runs
stay short, pass the long-run threshold and cross the walk's chunk
boundaries.  The wrapper's own checks and its CPU dispatch follow.  The
mesh engine's windows against the JAX mesh are in test_torch_mesh.py and
test_torch_reshard.py.
"""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke as cs
from gubernator_tpu_torch import _build
from gubernator_tpu_torch.carry import sharded_table_from_columns
from gubernator_tpu_torch.ops import engine as E
from gubernator_tpu_torch.ops.tiletick import (
    mesh_tile_tick, mesh_tile_tick_plain)

NOW = cs.NOW
SHARDS, LOCAL = 3, 512
# Every kind at 700 lanes (runs past a warp's 32 lanes, chunks of 256);
# a few at 96 (short runs, one chunk an extent) and 2048 (chunks of 704,
# runs past a run block's 256 lanes).
CASES = ([(k, 700) for k in cs.TILE_KINDS]
         + [(k, 96) for k in ("mixed", "invalid", "reset")]
         + [(k, 2048) for k in ("mixed", "invalid", "runs", "cross")])


def _host_lib():
    lib = _build.load("fused_tick_host")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gt_mesh_tile_tick_host.restype = ctypes.c_int
    lib.gt_mesh_tile_tick_host.argtypes = [
        vp, i64, i64, vp, vp, i64, vp, i64, i64, i64, i64, vp, i64, vp]
    lib.gt_mesh_tile_tick_scratch_words_host.restype = i64
    lib.gt_mesh_tile_tick_scratch_words_host.argtypes = [i64, i64, i64]
    return lib


def tile_case(kind: str, lanes: int, seed: int):
    rng = np.random.default_rng(seed)
    state = cs.random_state(rng, SHARDS * LOCAL)
    m, offs, tile = cs.tile_window(E, rng, SHARDS, LOCAL, lanes, state, kind)
    return state, m, offs, tile


def host_tick(table, m, offs, tile, scratch=None, epoch=1):
    """The host build on ``table`` in place: ``(resp, rounds)``.  The
    scratch is the caller's, as the kernel's is (zeroed once, one epoch a
    launch); without one a zeroed one is made."""
    lanes = m.shape[1]
    mt = torch.from_numpy(m)
    ot = torch.from_numpy(offs)
    resp = torch.full((6, lanes), -7, dtype=torch.int32)
    lib = _host_lib()
    if scratch is None:
        scratch = torch.zeros(lib.gt_mesh_tile_tick_scratch_words_host(
            lanes, tile, SHARDS), dtype=torch.int64)
    rounds = torch.zeros(1, dtype=torch.int64)
    rc = lib.gt_mesh_tile_tick_host(
        table.data_ptr(), SHARDS, LOCAL, ot.data_ptr(), mt.data_ptr(),
        mt.stride(0), resp.data_ptr(), resp.stride(0), lanes, tile, NOW,
        scratch.data_ptr(), epoch, rounds.data_ptr())
    assert rc == 0
    return resp, int(rounds)


@pytest.mark.parametrize("kind,lanes", CASES)
def test_tile_lane_code_on_host_matches_plain(kind, lanes):
    state, m, offs, tile = tile_case(kind, lanes, 7 + lanes)
    t_plain = sharded_table_from_columns(state, SHARDS, LOCAL, "cpu")
    t_host = t_plain.clone()
    rounds = torch.zeros(1, dtype=torch.int64)
    r_plain = mesh_tile_tick_plain(
        t_plain, torch.from_numpy(m), torch.from_numpy(offs), SHARDS, LOCAL,
        tile, NOW, rounds, torch.empty((6, lanes), dtype=torch.int32))
    r_host, host_rounds = host_tick(t_host, m, offs, tile)
    assert torch.equal(r_host, r_plain)
    assert torch.equal(t_host, t_plain)
    assert host_rounds == int(rounds)


# Tiles the walk never picks (not a multiple of a warp; four lanes), which
# the contract allows: groups inside a warp's 32 lanes that cross a chunk
# boundary, and runs of more pieces than a run block flags at a time.
ODD_TILES = [("runs", 700, 20), ("mixed", 700, 20), ("invalid", 700, 20),
             ("runs", 2048, 4)]


@pytest.mark.parametrize("kind,lanes,tile", ODD_TILES)
def test_tile_lane_code_on_host_at_any_tile(kind, lanes, tile):
    state, m, offs, _ = tile_case(kind, lanes, 11 + lanes)
    t_plain = sharded_table_from_columns(state, SHARDS, LOCAL, "cpu")
    t_host = t_plain.clone()
    rounds = torch.zeros(1, dtype=torch.int64)
    r_plain = mesh_tile_tick_plain(
        t_plain, torch.from_numpy(m), torch.from_numpy(offs), SHARDS, LOCAL,
        tile, NOW, rounds, torch.empty((6, lanes), dtype=torch.int32))
    r_host, host_rounds = host_tick(t_host, m, offs, tile)
    assert torch.equal(r_host, r_plain)
    assert torch.equal(t_host, t_plain)
    assert host_rounds == int(rounds)


def test_tile_lane_code_on_host_keeps_its_scratch():
    """Windows one after another on one scratch, one epoch each (the
    kernel's launches on a caller's scratch): each as the plain version,
    whatever the windows before it left in the scratch."""
    lanes = 1024
    lib = _host_lib()
    t_host = t_plain = None
    scratch = None
    for step, kind in enumerate(("runs", "mixed", "runs")):
        state, m, offs, tile = tile_case(kind, lanes, 40 + step)
        if t_plain is None:
            t_plain = sharded_table_from_columns(state, SHARDS, LOCAL, "cpu")
            t_host = t_plain.clone()
            scratch = torch.zeros(lib.gt_mesh_tile_tick_scratch_words_host(
                lanes, 64, SHARDS), dtype=torch.int64)
        rounds = torch.zeros(1, dtype=torch.int64)
        r_plain = mesh_tile_tick_plain(
            t_plain, torch.from_numpy(m), torch.from_numpy(offs), SHARDS,
            LOCAL, tile, NOW, rounds,
            torch.empty((6, lanes), dtype=torch.int32))
        r_host, host_rounds = host_tick(t_host, m, offs, tile, scratch,
                                        epoch=step + 1)
        assert torch.equal(r_host, r_plain)
        assert torch.equal(t_host, t_plain)
        assert host_rounds == int(rounds)
    ctrl = scratch[:3].numpy().view(np.uint32)
    assert (ctrl == 0).all()  # the queue's counters (24 bytes) back at 0


def test_tile_window_shapes():
    """The kinds reach what they are for: a herd is one run longer than a
    chunk; cross windows hold runs that span a chunk boundary; a skewed
    window is one extent."""
    _, m, offs, tile = tile_case("herd", 2048, 1)
    slot = m[E.REQ32_INDEX["slot"], :offs[-1]]
    assert len(np.unique(slot)) == 1 and offs[-1] > tile
    _, m, offs, tile = tile_case("cross", 2048, 2)
    slot = m[E.REQ32_INDEX["slot"]]
    crossing = 0
    for s in range(SHARDS):
        for b in range(offs[s] + tile, offs[s + 1], tile):
            crossing += slot[b] == slot[b - 1]
    assert crossing > 0
    _, _, offs, _ = tile_case("skewed", 700, 3)
    assert offs[1] == offs[-1]


def test_folded_herd_runs_no_rounds():
    """A herd whose requests prove their head alive folds in closed form:
    no rank round; its follower answers count down."""
    rng = np.random.default_rng(5)
    state = cs.random_state(rng, SHARDS * LOCAL)
    m, offs, tile = cs.tile_window(E, rng, SHARDS, LOCAL, 700, state, "herd")
    R = E.REQ32_INDEX
    n = int(offs[-1])
    m[R["algorithm"], :n] = 0
    m[R["behavior"], :n] = 0
    m[R["known"], :n] = 1
    for f, v in (("hits", 1), ("limit", 10**6), ("duration", 60_000),
                 ("created_at", NOW), ("burst", 0)):
        E.pack_wide_rows(m, f, np.full(n, v), slice(0, n))
    table = sharded_table_from_columns(state, SHARDS, LOCAL, "cpu")
    rounds = torch.zeros(1, dtype=torch.int64)
    out = mesh_tile_tick(table, torch.from_numpy(m), torch.from_numpy(offs),
                         SHARDS, LOCAL, tile, NOW, rounds)
    assert int(rounds) == 0
    rem = out[2, :n].long().numpy()
    assert (np.diff(rem[rem > 0]) < 0).all()
    assert (out[:, n:] == 0).all()


def test_wrapper_checks():
    table = torch.zeros((SHARDS * (LOCAL + 1), 16), dtype=torch.int64)
    m = torch.zeros((19, 8), dtype=torch.int32)
    offs = torch.zeros(SHARDS + 1, dtype=torch.int32)
    rounds = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="blocks"):
        mesh_tile_tick(table, m, offs, SHARDS + 1, LOCAL, 8, NOW, rounds)
    with pytest.raises(ValueError, match="offsets"):
        mesh_tile_tick(table, m, offs[:2], SHARDS, LOCAL, 8, NOW, rounds)
    with pytest.raises(ValueError, match="rounds"):
        mesh_tile_tick(table, m, offs, SHARDS, LOCAL, 8, NOW,
                       torch.zeros(2, dtype=torch.int64))
    out = mesh_tile_tick(table, m, offs, SHARDS, LOCAL, 8, NOW, rounds)
    assert out.shape == (6, 8) and (out == 0).all()
