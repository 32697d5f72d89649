"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels build
with ``nvcc`` at first use); without one they skip.  They cover shapes the
main path does not reach in ``chip_smoke.py``: widths that are not a
multiple of a block, column slices, merged-tick launches into row slices
of one journal, the merged tick at its tile shapes and at the fold's
32-bit division edges, rows narrower than 16 words, out-of-range and
guard-row slots, ragged windows with empty shards, inert lanes and slots outside
their shard, the chained duplicate tick on Zipf windows, one-segment
windows and EDGE windows at 1-4096 lanes, the engine on a tiny table that
fills and reclaims (with herd windows on the grouped plan and random
windows on the chained tick), its state exported and loaded, layered
windows on a 2^14-slot table, the mesh engine on four tiny shards, the
tiered engine (Store, cold and SSD tiers) against the same engine on the
CPU, and background reclaim under concurrent ticks.  They import nothing of JAX, so
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
from gubernator_tpu_torch.ops.sortedtick import (
    fused_sorted_tick, fused_sorted_tick_plain)
from gubernator_tpu_torch.types import GlobalUpdate, RateLimitResponse
from gubernator_tpu_torch.parallel.mesh_engine import MeshTickEngine

pytestmark = pytest.mark.cuda

# The unique-slot ticks' tile shapes (csrc/tile.cuh): one lane, the edges
# of the one-thread-a-lane path (8 / 9 lanes) and of the 64-lane tile,
# 255-257 lanes; windows mixed, of one algorithm each, or of EDGE lanes
# only.  The CPU tests hold the host build of the kernels' tile code
# against the plain versions on the same cases.
TILE_WIDTHS = (1, 8, 9, 63, 64, 65, 255, 256, 257)
TILE_KINDS = ("mixed", "edge") + cs.ALGORITHMS


def tick_case(kind: str, width: int, seed: int, cap: int = 1024):
    """``(state, m)``: random stored state of ``cap`` slots and a window
    of kind ``kind`` whose first ``width`` columns are the case.  Below 128
    lanes ``m`` is wider (slice it on the device: ld_m > B, as rank rounds
    pass, every lane live); from 128 up it is a whole window ending in 64
    padding lanes.  From 9 lanes up lane 3 has valid == 0 and lane 5 a
    slot past the table."""
    rng = np.random.default_rng(seed)
    state = cs.random_state(rng, cap)
    if kind == "edge":
        m = cs.edge_window(E, rng, width, state)
    else:
        m, n = cs.fused_window(E, rng, cap, max(width, 128 + 64), state)
        if kind != "mixed":
            m = cs.with_algorithm(E, m, cs.ALGORITHMS.index(kind), n)
    if width >= 9:
        m[E.REQ32_INDEX["valid"], 3] = 0
        m[E.REQ32_INDEX["slot"], 5] = cap + 5
    return state, m


def ragged_case(kind: str, width: int, seed: int, shards: int = 3,
                local: int = 512):
    """``(state, m, offsets)`` for the ragged tick over ``shards`` shards
    of ``local`` slots: the first ``width`` columns of ``m`` (a wider
    balanced or skewed window; offsets clipped to them) or a window of
    EDGE lanes on shard 0."""
    rng = np.random.default_rng(seed)
    state = cs.random_state(rng, shards * local)
    if kind == "edge":
        m = cs.edge_window(E, rng, width, state)
        offs = np.array([0] + [width] * shards, np.int32)
    else:
        m, offs, _ = cs.ragged_window(E, rng, shards, local,
                                      max(width, 128) + 64, state,
                                      skew=kind == "skewed")
        offs = np.minimum(offs, width).astype(np.int32)
    return state, m, offs


# The merged tick's tile shapes: the unique ticks' and a 512-head layer of
# the layered plan; head windows mixed, of EDGE lanes only, or of token,
# leaky or zoo heads only.
MERGED_WIDTHS = TILE_WIDTHS + (512,)
MERGED_KINDS = ("mixed", "edge", "token", "leaky", "zoo")


def merged_case(kind: str, width: int, seed: int, cap: int = 1024):
    """``(state, m, count)``: random stored state of ``cap`` slots, a head
    window of kind ``kind`` whose first ``width`` columns are the case
    (``m`` is wider below 192 heads: slice it on the device, ld_m > U) and
    group sizes up to 1000, every seventh head alone.  From 9 heads up
    head 3 is padding aimed at ``capacity`` and head 5 has valid == 0."""
    rng = np.random.default_rng(seed)
    state = cs.random_state(rng, cap)
    R = E.REQ32_INDEX
    if kind == "edge":
        m = cs.edge_window(E, rng, width, state)
    else:
        m, _, n = cs.merged_window(E, rng, cap, max(width, 128 + 64), state)
        if kind != "mixed":
            m[R["algorithm"], :n] = (
                rng.integers(2, 5, n) if kind == "zoo"
                else cs.ALGORITHMS.index(kind))
    count = rng.integers(1, 1001, m.shape[1]).astype(np.int32)
    count[::7] = 1
    if width >= 9:
        m[R["slot"], 3] = cap
        m[R["valid"], 5] = 0
    return state, m, count


# The fold's divisions at their 32-bit edges (csrc/transition.cuh
# merged_fold): rate_i = max(duration, 0) // limit over these limits and
# durations, and q = max(base, 0) // hits over bases and hits around 2^32.
FOLD_LIMITS = (-7, 0, 1, 2**31 - 1, 2**32 - 1, 2**32, 2**32 + 1)
FOLD_DURATIONS = (-5, 0, 2**32 - 1, 2**32)
FOLD_BASES = (2**31 - 1, 2**32 - 1, 2**32, 2**32 + 1, 2**33)
FOLD_HITS = (1, 3, 2**32 - 1, 2**32)


def division_case(cap: int = 1024):
    """``(state, m, count)``: token and leaky heads on slots 0.. at the
    fold's division edges, every head with followers and no leak (the
    stored row was updated at the request's time), half of them draining."""
    rng = np.random.default_rng(17)
    state = cs.random_state(rng, cap)
    edges = []
    for alg in (0, 1):
        edges += [(dict(algorithm=alg, limit=lim, duration=dur, hits=1),
                   dict(algorithm=alg, limit=lim, duration=dur))
                  for lim in FOLD_LIMITS for dur in FOLD_DURATIONS]
        big = 2**40
        edges += [(dict(algorithm=alg, limit=big, duration=60_000, hits=h,
                        burst=big),
                   dict(algorithm=alg, limit=big, duration=60_000, burst=big,
                        remaining=b + h, remaining_f=b + h + 0.5))
                  for b in FOLD_BASES for h in FOLD_HITS]
    n = len(edges)
    req = cs.random_requests(rng, n)
    for k, edge in enumerate(edges):
        cs._set_edge(req, state, k, k, edge)
        state["updated_at"][k] = cs.NOW
    req["created_at"][:] = cs.NOW
    req["behavior"][:] = np.where(np.arange(n) % 2, 32, 0)
    m = cs._pack(E, cap, n, np.arange(n), req)
    count = rng.integers(2, 1001, n).astype(np.int32)
    return state, m, count


# The chained duplicate tick's shapes: one lane, the edges of a warp and
# of a block, 257 and 4096 lanes; Zipf(1.2) windows, windows of one
# segment as long as the window, and EDGE windows (a few lanes a slot).
SORTED_WIDTHS = (1, 8, 9, 64, 65, 257, 4096)
SORTED_KINDS = ("zipf", "one", "edge")


def sorted_case(kind: str, width: int, seed: int, cap: int = 1024):
    """``(state, m)``: random stored state of ``cap`` slots and a
    slot-sorted (19, width) window of kind ``kind`` whose slots repeat.
    From 9 lanes up lane 3 has valid == 0 (inside its segment) and a Zipf
    window's lane 0 a negative slot."""
    rng = np.random.default_rng(seed)
    state = cs.random_state(rng, cap)
    R = E.REQ32_INDEX
    if kind == "edge":
        req = cs.random_requests(rng, width)
        slots = np.arange(width) * min(cap, -(-width // 3)) // width
        for k in range(width):
            cs._set_edge(req, state, k, slots[k], cs.EDGE[k % len(cs.EDGE)])
        m = cs._pack(E, cap, width, slots, req)
    else:
        m = cs.sorted_window(E, rng, cap, width, state,
                             one_slot=kind == "one")
    if width >= 9:
        m[R["valid"], 3] = 0
        if kind == "zipf":
            m[R["slot"], 0] = -1
    return state, m


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


@pytest.mark.parametrize("width", TILE_WIDTHS)
@pytest.mark.parametrize("kind", TILE_KINDS)
def test_fused_tick_tile_shapes_match_plain(dev, kind, width):
    state, m = tick_case(kind, width, seed=width)
    cap = len(state["algorithm"])
    table = table_from_columns(state, cap, dev)
    mt = torch.from_numpy(m).to(dev)[:, :width]
    t_k, t_p = table.clone(), table.clone()
    r_k = fused_tick(t_k, mt, cs.NOW)
    r_p = fused_tick_plain(t_p, mt, cs.NOW, torch.empty_like(r_k))
    assert torch.equal(r_k, r_p)
    assert torch.equal(t_k, t_p)


@pytest.mark.parametrize("width", (1, 8, 9, 64, 65, 257))
@pytest.mark.parametrize("kind", ("balanced", "skewed", "edge"))
def test_fused_ragged_tick_tile_shapes_match_plain(dev, kind, width):
    state, m, offs = ragged_case(kind, width, seed=width)
    table = sharded_table_from_columns(state, 3, 512, dev)
    mt = torch.from_numpy(m).to(dev)[:, :width]
    ot = torch.from_numpy(offs).to(dev)
    t_k, t_p = table.clone(), table.clone()
    r_k = fused_ragged_tick(t_k, mt, ot, 3, 512, cs.NOW)
    r_p = fused_ragged_tick_plain(t_p, mt, ot, 3, 512, cs.NOW,
                                  torch.empty_like(r_k))
    assert torch.equal(r_k, r_p)
    assert torch.equal(t_k, t_p)


@pytest.mark.parametrize("width", SORTED_WIDTHS)
@pytest.mark.parametrize("kind", SORTED_KINDS)
def test_fused_sorted_tick_matches_plain(dev, kind, width):
    state, m = sorted_case(kind, width, seed=width)
    table = table_from_columns(state, 1024, dev)
    mt = torch.from_numpy(m).to(dev)
    t_k, t_p = table.clone(), table.clone()
    gt.reset_kernel_launches()
    r_k = fused_sorted_tick(t_k, mt, cs.NOW)
    torch.cuda.synchronize()
    launches = gt.kernel_launches()
    assert launches.pop("fused_sorted_tick") == 1
    assert not any(launches.values())
    r_p = fused_sorted_tick_plain(t_p, mt, cs.NOW, torch.empty_like(r_k))
    assert torch.equal(r_k, r_p)
    assert torch.equal(t_k, t_p)
    assert (t_k[1024] == 0).all()


def test_tick_launches_counted_by_width(dev):
    gt.reset_kernel_launches()
    state, m = tick_case("mixed", 257, seed=1)
    table = table_from_columns(state, 1024, dev)
    mt = torch.from_numpy(m).to(dev)
    for w in (1, 2, 3, 64, 65, 257):
        fused_tick(table, mt[:, :w], cs.NOW)
    assert gt.kernel_launches()["fused_tick"] == 6
    assert gt.kernel_launches_by_width()["fused_tick"] == {
        1: 1, 2: 1, 4: 1, 64: 1, 128: 1, 512: 1}


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


def merged_on(dev, state, m, count, width):
    """The merged tick and its plain version on copies of ``state``'s
    table, the first ``width`` heads of ``m``, the kernel's journal a row
    slice of a wider one: both must agree bit for bit, rows outside the
    slice untouched."""
    cap = len(state["algorithm"])
    table = table_from_columns(state, cap, dev)
    mt = torch.from_numpy(m).to(dev)[:, :width]
    ct = torch.from_numpy(count[:width]).to(dev)
    t_k, t_p = table.clone(), table.clone()
    journal = torch.full((width + 16, 24), -1, dtype=torch.int32, device=dev)
    fused_merged_tick(t_k, mt, ct, cs.NOW, out=journal[8:8 + width])
    want = fused_merged_tick_plain(
        t_p, mt, ct, cs.NOW,
        torch.empty((width, 24), dtype=torch.int32, device=dev))
    assert torch.equal(journal[8:8 + width], want)
    assert (journal[:8] == -1).all() and (journal[8 + width:] == -1).all()
    assert torch.equal(t_k, t_p)


@pytest.mark.parametrize("width", MERGED_WIDTHS)
@pytest.mark.parametrize("kind", MERGED_KINDS)
def test_fused_merged_tick_tile_shapes_match_plain(dev, kind, width):
    merged_on(dev, *merged_case(kind, width, seed=width), width)


def test_fused_merged_fold_division_edges_match_plain(dev):
    state, m, count = division_case()
    merged_on(dev, state, m, count, m.shape[1])


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
    # Windows neither plan takes: one chained launch each on the card,
    # rank rounds on the CPU.
    assert eng.metric_sorted_ticks == ref.metric_sorted_ticks > 0
    assert eng.metric_rank_rounds == 0 and ref.metric_rank_rounds > 0
    assert eng.metric_unexpired_evictions > 0
    assert eng.metric_grouped_ticks == 3
    launches = gt.kernel_launches()
    assert launches.pop("fused_ragged_tick") == 0
    assert launches["fused_sorted_tick"] == eng.metric_sorted_ticks
    assert all(v > 0 for v in launches.values())
    assert torch.equal(eng.table.cpu(), ref.table)


def assert_snapshots_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for f in want:
        if f == "key_blob":
            assert bytes(got[f]) == bytes(want[f])
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_state_movement_on_the_card_matches_the_cpu_engine(dev):
    """Windows, a GLOBAL install and lease windows on both engines, then
    each engine's export loaded into a fresh engine of its device: every
    export, delta and lease readback equal to the CPU engine's."""
    rng = np.random.default_rng(14)
    engines = [E.TickEngine(capacity=64, max_batch=48, device=d)
               for d in (dev, "cpu")]
    now = cs.NOW
    ids = rng.integers(0, 40, 48)
    keys = [b"k" + b"%08d" % i for i in range(40)]
    first = cs.window_columns(reqcols, rng, b"k", ids, now)
    cols = cs.window_columns(reqcols, rng, b"k", ids[:20], now + 10)
    for eng in engines:
        eng.process_columns(first, now)
        eng.export_columns()
    ups = [GlobalUpdate(key=f"g{i % 5}", algorithm=i % 2, duration=60_000,
                        status=RateLimitResponse(
                            status=i % 2, limit=10 + i, remaining=i,
                            reset_time=now + 1_000 * i)) for i in range(8)]
    snaps = []
    for eng in engines:
        eng.process_columns(cols, now + 10)
        eng.install_globals(ups, now + 20)
        eng.lease_window(keys[:10], range(10), [now + 5] * 10, [1] * 10)
        eng.lease_window(keys[5:15], [-3] * 10, [now + 9] * 10, [0] * 10,
                         is_set=False)
        snaps.append((eng.export_columns(dirty_only=True),
                      eng.export_columns(),
                      eng.lease_columns(keys[:20])))
        fresh = E.TickEngine(capacity=64, max_batch=48, device=eng.device)
        fresh.load_columns(snaps[-1][1], now + 30)
        snaps[-1] += (fresh.export_columns(),)
    for got, want in zip(*snaps):
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        else:
            assert_snapshots_equal(got, want)
    assert len(snaps[0][0]["key_offsets"]) > 1
    assert torch.equal(engines[0].table.cpu(), engines[1].table)


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
    # The mesh's duplicate tiles run rank rounds of the fused tick.
    assert launches.pop("fused_merged_tick") == 0
    assert launches.pop("fused_sorted_tick") == 0
    assert all(v > 0 for v in launches.values())
    assert torch.equal(eng.table.cpu(), ref.table)


def test_tiered_engine_on_the_card_matches_the_cpu_engine(dev, tmp_path):
    """A Store, a cold tier and an SSD tier under windows of uniform draws
    (every algorithm): responses, export, tier counts and the Store's
    contents equal the CPU engine's bit for bit."""
    info = cs.tier_compare(torch, dev, str(tmp_path), capacity=512,
                           width=256, cold_capacity=256, windows=12,
                           keys=4096)
    assert info["cold_hits"] > 0 and info["ssd_hits"] > 0
    assert info["promote_dispatches"] == info["promote_ticks"]


def test_background_reclaim_on_the_card_keeps_every_live_key(dev):
    """The reclaimer's dead test, demote gather and evict scatter run on
    the serving thread's stream while windows keep ticking: every answer
    is its key's exact count (no live key's state lost or shared)."""
    info = cs.bg_continuity(torch, dev, capacity=4096, width=512,
                            working_set=3 * 4096, windows=120)
    assert info["bg_rounds"] > 0 and info["evictions"] > 0
    assert info["continuity_errors"] == 0 and info["shed"] == 0
