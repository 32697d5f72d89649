"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels build
with ``nvcc`` at first use); without one they skip.  They cover shapes the
main path does not reach in ``chip_smoke.py``: widths that are not a
multiple of a block, column slices, merged-tick launches into row slices
of one journal, rows narrower than 16 words, out-of-range and guard-row
slots, ragged windows with empty shards, inert lanes and slots outside
their shard, the engine on a tiny table that fills and reclaims (with herd
windows on the grouped plan), layered windows on a 2^14-slot table, and
the mesh engine on four tiny shards.  They import nothing of JAX, so
they run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import gubernator_tpu_torch as gt
from gubernator_tpu_torch.carry import (
    sharded_table_from_columns, table_from_columns)
from gubernator_tpu_torch.ops import engine as E
from gubernator_tpu_torch.ops import reqcols, rowtable
from gubernator_tpu_torch.ops.fusedtick import (
    fused_merged_tick, fused_merged_tick_plain, fused_tick, fused_tick_plain)
from gubernator_tpu_torch.ops.raggedtick import (
    fused_ragged_tick, fused_ragged_tick_plain)
from gubernator_tpu_torch.parallel.mesh_engine import MeshTickEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("cap,lanes", [(256, 128), (1000, 300), (70, 129)])
def test_fused_tick_matches_plain(dev, cap, lanes):
    rng = np.random.default_rng(cap + lanes)
    state = cs.random_state(rng, cap)
    m, _ = cs.fused_window(E, rng, cap, lanes, state)
    table = table_from_columns(state, cap, dev)
    mt = torch.from_numpy(m).to(dev)
    t_k, t_p = table.clone(), table.clone()
    r_k = fused_tick(t_k, mt, cs.NOW)
    r_p = fused_tick_plain(t_p, mt, cs.NOW, torch.empty_like(r_k))
    assert torch.equal(r_k, r_p)
    assert torch.equal(t_k, t_p)
    assert (t_k[cap] == 0).all()


def test_fused_tick_on_a_column_slice(dev):
    rng = np.random.default_rng(3)
    cap, lanes = 512, 256
    state = cs.random_state(rng, cap)
    m, _ = cs.fused_window(E, rng, cap, lanes, state)
    table = table_from_columns(state, cap, dev)
    mt = torch.from_numpy(m).to(dev)
    t_k, t_p = table.clone(), table.clone()
    out = torch.full((6, lanes), -1, dtype=torch.int32, device=dev)
    fused_tick(t_k, mt[:, 17:200], cs.NOW, out=out[:, 17:200])
    want = fused_tick_plain(t_p, mt[:, 17:200].contiguous(), cs.NOW,
                            torch.empty((6, 183), dtype=torch.int32,
                                        device=dev))
    assert torch.equal(out[:, 17:200], want)
    assert (out[:, :17] == -1).all() and (out[:, 200:] == -1).all()
    assert torch.equal(t_k, t_p)


@pytest.mark.parametrize("cap,heads", [(300, 129), (1000, 300), (4096, 1000)])
def test_fused_merged_tick_matches_plain(dev, cap, heads):
    rng = np.random.default_rng(cap + heads)
    state = cs.random_state(rng, cap)
    m, count, _ = cs.merged_window(E, rng, cap, heads, state)
    table = table_from_columns(state, cap, dev)
    mt, ct = torch.from_numpy(m).to(dev), torch.from_numpy(count).to(dev)
    t_k, t_p = table.clone(), table.clone()
    j_k = fused_merged_tick(t_k, mt, ct, cs.NOW)
    j_p = fused_merged_tick_plain(t_p, mt, ct, cs.NOW, torch.empty_like(j_k))
    assert torch.equal(j_k, j_p)
    assert torch.equal(t_k, t_p)
    assert (t_k[cap] == 0).all()


def test_fused_merged_tick_into_journal_slices(dev):
    """The layered pipeline's launches: column slices of one head matrix,
    each writing a row slice of one flat journal."""
    rng = np.random.default_rng(5)
    cap, heads = 2048, 600
    state = cs.random_state(rng, cap)
    m, count, _ = cs.merged_window(E, rng, cap, heads, state)
    table = table_from_columns(state, cap, dev)
    mt, ct = torch.from_numpy(m).to(dev), torch.from_numpy(count).to(dev)
    t_k, t_p = table.clone(), table.clone()
    journal = torch.full((heads + 8, 24), -1, dtype=torch.int32, device=dev)
    for a, b in ((0, 256), (256, heads)):
        fused_merged_tick(t_k, mt[:, a:b], ct[a:b], cs.NOW,
                          out=journal[a + 8:b + 8])
        want = fused_merged_tick_plain(
            t_p, mt[:, a:b].contiguous(), ct[a:b].contiguous(), cs.NOW,
            torch.empty((b - a, 24), dtype=torch.int32, device=dev))
        assert torch.equal(journal[a + 8:b + 8], want)
    assert (journal[:8] == -1).all()
    assert torch.equal(t_k, t_p)


@pytest.mark.parametrize("width", [16, 4])
def test_gather_and_scatter_match_plain(dev, width):
    g = torch.Generator().manual_seed(width)
    cap = 333
    table = torch.randint(-2**62, 2**62, (cap + 1, width), generator=g,
                          dtype=torch.int64).to(dev)
    slots = torch.randperm(cap, generator=g)[:200].to(dev)
    slots[::7] = cap                  # guard-row lanes
    odd = slots.clone()
    odd[1::11] = -5                   # gathers clamp out-of-range slots
    odd[2::11] = cap + 9
    assert torch.equal(rowtable.gather_rows(table, odd),
                       rowtable.gather_rows_plain(table, odd))
    rows = torch.randint(-2**62, 2**62, (200, width), generator=g,
                         dtype=torch.int64).to(dev)
    t_k, t_p = table.clone(), table.clone()
    rowtable.scatter_rows(t_k, slots, rows)
    rowtable.scatter_rows_plain(t_p, slots, rows)
    assert torch.equal(t_k, t_p)
    assert torch.equal(t_k[cap], table[cap])  # the guard row is never written


def test_engine_on_the_card_matches_the_cpu_engine(dev):
    gt.reset_kernel_launches()
    rng = np.random.default_rng(11)
    eng = E.TickEngine(capacity=64, max_batch=48, device=dev)
    ref = E.TickEngine(capacity=64, max_batch=48, device="cpu")
    now = cs.NOW
    for step in range(9):
        now += 700
        if step % 3 == 2:   # a herd: the grouped plan
            cols = cs.herd_columns(reqcols, b"h", rng.integers(0, 12, 48))
        else:
            ids = (rng.integers(0, 90, 48) if step % 3
                   else rng.permutation(48))
            cols = cs.window_columns(reqcols, rng, b"k", ids, now)
        got, gerr = eng.process_columns(cols, now)
        want, werr = ref.process_columns(cols, now)
        assert gerr == werr
        np.testing.assert_array_equal(got, want)
    assert eng.metric_rank_rounds > 0 and eng.metric_unexpired_evictions > 0
    assert eng.metric_grouped_ticks == 3
    launches = gt.kernel_launches()
    assert launches.pop("fused_ragged_tick") == 0
    assert all(v > 0 for v in launches.values())
    assert torch.equal(eng.table.cpu(), ref.table)


def test_layered_windows_on_the_card_match_the_cpu_engine(dev):
    gt.reset_kernel_launches()
    rng = np.random.default_rng(12)
    eng = E.TickEngine(capacity=1 << 14, max_batch=512, device=dev)
    ref = E.TickEngine(capacity=1 << 14, max_batch=512, device="cpu")
    now = cs.NOW
    for step in range(3):
        now += 1_000
        ids = (rng.zipf(1.2, 512) - 1) % 2000
        cols = cs.herd_columns(reqcols, b"l", ids,
                               reset=cs.reset_flags(rng, ids, hot=16))
        got, gerr = eng.process_columns(cols, now)
        want, werr = ref.process_columns(cols, now)
        assert gerr == werr
        np.testing.assert_array_equal(got, want)
    assert eng.metric_layered_ticks == ref.metric_layered_ticks == 3
    assert eng.metric_rank_rounds == 0
    assert gt.kernel_launches()["fused_merged_tick"] >= 6
    assert torch.equal(eng.table.cpu(), ref.table)


@pytest.mark.parametrize("shards,local,lanes,skew", [
    (8, 512, 2048, False), (8, 4096, 2048, True), (3, 100, 129, False),
    (1, 700, 300, False)])
def test_fused_ragged_tick_matches_plain(dev, shards, local, lanes, skew):
    rng = np.random.default_rng(shards * 1000 + lanes + skew)
    state = cs.random_state(rng, shards * local)
    m, offs, _ = cs.ragged_window(E, rng, shards, local, lanes, state, skew)
    m[E.REQ32_INDEX["valid"], 3] = 0                   # inert lane
    m[E.REQ32_INDEX["slot"], 7] = shards * local + 1  # outside its shard
    table = sharded_table_from_columns(state, shards, local, dev)
    mt, ot = torch.from_numpy(m).to(dev), torch.from_numpy(offs).to(dev)
    t_k, t_p = table.clone(), table.clone()
    r_k = fused_ragged_tick(t_k, mt, ot, shards, local, cs.NOW)
    r_p = fused_ragged_tick_plain(t_p, mt, ot, shards, local, cs.NOW,
                                  torch.empty_like(r_k))
    assert torch.equal(r_k, r_p)
    assert torch.equal(t_k, t_p)
    assert (r_k[:, [3, 7]] == 0).all() and (r_k[:, int(offs[-1]):] == 0).all()
    assert (t_k[local::local + 1] == 0).all()  # guard rows are never written


def test_mesh_engine_on_the_card_matches_the_cpu_engine(dev):
    gt.reset_kernel_launches()
    rng = np.random.default_rng(13)
    eng = MeshTickEngine(n_shards=4, local_capacity=16, max_batch=48,
                         device=dev)
    ref = MeshTickEngine(n_shards=4, local_capacity=16, max_batch=48,
                         device="cpu")
    now = cs.NOW
    for step in range(9):
        now += 700
        if step % 3 == 2:   # a herd: the merge tick's closed-form fold
            cols = cs.herd_columns(reqcols, b"h", rng.integers(0, 12, 48))
        else:
            ids = (rng.integers(0, 90, 48) if step % 3
                   else rng.permutation(48))
            cols = cs.window_columns(reqcols, rng, b"k", ids, now)
        got, gerr = eng.process_columns(cols, now)
        want, werr = ref.process_columns(cols, now)
        assert gerr == werr
        np.testing.assert_array_equal(got, want)
    assert eng.metric_rank_rounds == ref.metric_rank_rounds > 0
    assert eng.metric_unexpired_evictions > 0
    launches = gt.kernel_launches()
    assert launches.pop("fused_merged_tick") == 0
    assert all(v > 0 for v in launches.values())
    assert torch.equal(eng.table.cpu(), ref.table)
