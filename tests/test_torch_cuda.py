"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels build
with ``nvcc`` at first use); without one they skip.  They cover shapes the
main path does not reach in ``chip_smoke.py``: widths that are not a
multiple of a block, column slices, merged-tick launches into row slices
of one journal, the merged tick at its tile shapes and at the fold's
32-bit division edges, rows narrower than 16 words, out-of-range and
guard-row slots, ragged windows with empty shards, inert lanes and slots
outside their shard, the mesh's duplicate tile tick (B.6) on every
tile_window kind (each class of run its steps take, odd tiles, windows one
after another on one scratch), a card mesh resharded 8 -> 3 -> 8 against a
CPU one, the
chained duplicate tick on Zipf windows, one-segment windows and EDGE
windows at 1-4096 lanes and at its threshold and chunk shapes
(CHAIN_CASES), the engine on a tiny table that fills and reclaims (with
herd windows on the grouped plan and random windows on the chained tick,
and random Zipf windows with long segments), its state exported and
loaded, layered windows on a 2^14-slot table, the row gather at every tail
of its 32-row warps (0-625000 rows, 16- and 6-word rows, clamped slots),
the mesh engine on four tiny shards and its state paths (installs, a
Store, an items round trip) against the CPU mesh, the tiered engine
(Store, cold and SSD tiers) against the same engine on the CPU, background
reclaim under concurrent ticks, and a 3-node cluster of card engines
(against one of CPU engines on a seeded sequence, and GLOBAL counts
reconciled exactly), and the GLOBAL mesh's kernels B.8a-B.8d at phase 9's
shapes and on small meshes (odd node counts, padding lanes, overflowing
probes, B.8b's tiles with owner boundaries inside them), a card ``MeshGlobalEngine`` against a CPU one on phase 9 D's
sequence, a 2-region federated cluster of card engines against one of
CPU engines (phase 11 C's sequence), and an autoscaler driving a card
mesh and a CPU one down and up.  They import nothing of JAX, so they run where JAX is not
installed:

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
    fused_sorted_tick, fused_sorted_tick_plain, kernel_config)
from gubernator_tpu_torch.ops.tiletick import (
    mesh_tile_tick, mesh_tile_tick_plain)
from gubernator_tpu_torch.types import GlobalUpdate, RateLimitResponse
from gubernator_tpu_torch.parallel.mesh_engine import MeshTickEngine

pytestmark = pytest.mark.cuda

GLOBAL_KERNELS = ("global_accumulate", "global_dense_reconcile",
                  "global_sparse_probe", "global_sparse_apply")

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


# The chained tick's chunk shapes (csrc/sorted_tick.cuh,
# chip_smoke.CHAIN_SHAPES), each width as (chunks, lanes): chunks times
# the build's chunk plus lanes.  A segment of each length around one chunk
# (one thread or a long block) and two (two chunks, two and a lane),
# twice in a window, the second head at the last lane of a long block's
# range; a long segment whose lanes switch algorithm, RESET_REMAINING and
# DRAIN_OVER_LIMIT mid-run; a long segment of inert lanes only and one
# whose first chunk is inert; a long segment followed by a long run of
# padding; and a column slice (ld_m > B) that starts mid 16-B vector.
CHAIN_CASES = [(kind, (chunks, extra))
               for kind, chunks, extra in cs.CHAIN_SHAPES]
SORTED_CASES = ([(k, w) for k in SORTED_KINDS for w in SORTED_WIDTHS]
                + CHAIN_CASES)
SORTED_IDS = [f"{k}-{w}" if isinstance(w, int)
              else f"{k}-{w[0]}chunk{w[1]:+d}" for k, w in SORTED_CASES]


def case_lanes(width, chunk: int) -> int:
    """A SORTED_CASES width in lanes, for a build of chunk ``chunk``."""
    return width if isinstance(width, int) else width[0] * chunk + width[1]


def sorted_window_case(kind: str, width, chunk: int, cap: int = 1024):
    """``(state, m, cols)``: a SORTED_CASES case for a build of chunk
    ``chunk``, the window ``m[:, cols]``, seeded by its width in lanes (a
    CHAIN_CASES case is chip_smoke.chain_window on random stored state of
    ``cap`` slots)."""
    lanes = case_lanes(width, chunk)
    if kind in SORTED_KINDS:
        state, m = sorted_case(kind, lanes, lanes, cap)
        return state, m, slice(0, lanes)
    rng = np.random.default_rng(lanes)
    state = cs.random_state(rng, cap)
    m, cols = cs.chain_window(E, rng, cap, kind, lanes, state, chunk)
    return state, m, cols


# float64 -> int64 at the conversion's edges (csrc/transition.cuh
# trunc_i64: on the card, its guards as selects beside one conversion):
# NaN, the infinities, 2^63 and the largest double below it, -2^63 and the
# next double below it, and fractions of either sign.
TRUNC_EDGES = (float("nan"), float("inf"), -float("inf"), 2.0**63,
               2.0**63 - 1024, -2.0**63, -2.0**63 - 2048, 1e300, -1e300,
               0.5, -0.5, -0.0, 9.75, -9.75, 2.0**53 + 2)


def trunc_case(cap: int = 1024):
    """``(state, m)``: leaky queries (hits 0) on slots 0.. whose stored
    remaining_f is each of TRUNC_EDGES, the item alive, the burst int64's
    largest and no time elapsed, so each answer's remaining is the
    truncation of the stored value; then the same lanes with one hit."""
    rng = np.random.default_rng(19)
    state = cs.random_state(rng, cap)
    n = len(TRUNC_EDGES)
    big = 2**63 - 1
    lanes = slice(0, 2 * n)
    state["algorithm"][lanes] = 1
    state["remaining_f"][lanes] = TRUNC_EDGES * 2
    state["burst"][lanes] = big
    state["updated_at"][lanes] = cs.NOW
    state["expire_at"][lanes] = cs.NOW + 60_000
    state["in_use"][lanes] = True
    req = cs.random_requests(rng, 2 * n)
    req.update(algorithm=np.ones(2 * n, np.int64), known=np.ones(2 * n, bool),
               behavior=np.zeros(2 * n, np.int64),
               hits=np.repeat([0, 1], n), limit=np.full(2 * n, 10),
               duration=np.full(2 * n, 30_000), burst=np.full(2 * n, big),
               created_at=np.full(2 * n, cs.NOW))
    return state, cs._pack(E, cap, 2 * n, np.arange(2 * n), req)


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


@pytest.mark.parametrize("kind,width", SORTED_CASES, ids=SORTED_IDS)
def test_fused_sorted_tick_matches_plain(dev, kind, width):
    state, m, cols = sorted_window_case(kind, width,
                                        kernel_config()["chunk"])
    table = table_from_columns(state, 1024, dev)
    mt = torch.from_numpy(m).to(dev)[:, cols]
    t_k, t_p = table.clone(), table.clone()
    gt.reset_kernel_launches()
    r_k = fused_sorted_tick(t_k, mt, cs.NOW)
    torch.cuda.synchronize()
    launches = gt.kernel_launches()
    assert launches.pop("fused_sorted_tick") == 1
    assert not any(launches.values())
    r_p = fused_sorted_tick_plain(t_p, mt.contiguous(), cs.NOW,
                                  torch.empty_like(r_k))
    assert torch.equal(r_k, r_p)
    assert torch.equal(t_k, t_p)
    assert (t_k[1024] == 0).all()


def test_float_to_int_edges_match_plain(dev):
    state, m = trunc_case()
    table = table_from_columns(state, 1024, dev)
    mt = torch.from_numpy(m).to(dev)
    for kernel, plain in ((fused_tick, fused_tick_plain),
                          (fused_sorted_tick, fused_sorted_tick_plain)):
        t_k, t_p = table.clone(), table.clone()
        r_k = kernel(t_k, mt, cs.NOW)
        r_p = plain(t_p, mt, cs.NOW, torch.empty_like(r_k))
        assert torch.equal(r_k, r_p)
        assert torch.equal(t_k, t_p)


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


GATHER_ROWS = (0, 1, 7, 31, 33, 4097, 625000)


@pytest.mark.parametrize("width", [16, 6])
@pytest.mark.parametrize("n", GATHER_ROWS)
def test_gather_rows_matches_plain_at_every_tail(dev, n, width):
    """The row gather (a warp per 32 rows, 16-word rows at a compile-time
    width, any other even width at run time) on ``n`` random slots, some
    negative, at the guard row or past it (clamped), bit for bit."""
    g = torch.Generator().manual_seed(n * 31 + width)
    cap = 1 << 20 if n > 4097 else 5000
    table = torch.randint(-2**62, 2**62, (cap + 1, width), generator=g,
                          dtype=torch.int64).to(dev)
    slots = torch.randint(0, cap, (n,), generator=g, dtype=torch.int64)
    slots[1::13] = -1 - torch.arange(len(slots[1::13]))
    slots[2::13] = cap
    slots[3::13] = cap + 1 + torch.arange(len(slots[3::13]))
    slots = slots.to(dev)
    r0 = rowtable.gather_rows.launches
    got = rowtable.gather_rows(table, slots)
    assert rowtable.gather_rows.launches == r0 + 1
    assert got.shape == (n, width)
    assert torch.equal(got, rowtable.gather_rows_plain(table, slots))


def test_mesh_state_paths_on_the_card_match_the_cpu_mesh(dev):
    """Installs, a Store's windows and an items round trip on a card mesh
    equal the CPU mesh's (answers, exported items, Store calls), in one
    row kernel launch a STATE_CHUNK, with every guard row zero."""
    launches, widths = {}, {}
    info = cs.mesh_state_paths(
        torch, dev, n_shards=4, local_capacity=2048, width=256,
        ref_local_capacity=1024, launches=launches, widths=widths,
        installs=512, store_windows=3, store_width=256,
        round_trip_per_shard=1024)
    assert info["round_trip"]["items"] == 4096
    assert info["store"]["calls"]["get"] > 0


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
    assert launches.pop("mesh_tile_tick") == 0  # no mesh here
    assert launches.pop("lease_apply") == 0  # no lease window here
    for name in GLOBAL_KERNELS:  # no GLOBAL mesh here
        assert launches.pop(name) == 0
    assert launches["fused_sorted_tick"] == eng.metric_sorted_ticks
    assert all(v > 0 for v in launches.values())
    assert torch.equal(eng.table.cpu(), ref.table)


def test_engine_random_zipf_windows_on_the_card_match_the_cpu_engine(dev):
    """Random Zipf(1.2) windows (neither plan takes them) whose hottest key
    has more than a chunk of requests: one chained launch each on the card,
    long segments included, against rank rounds on the CPU engine."""
    gt.reset_kernel_launches()
    rng = np.random.default_rng(15)
    eng = E.TickEngine(capacity=1024, max_batch=2048, device=dev)
    ref = E.TickEngine(capacity=1024, max_batch=2048, device="cpu")
    now = cs.NOW
    longest = 0
    for step in range(3):
        now += 1_000
        ids = (rng.zipf(1.2, 2048) - 1) % 900
        longest = max(longest, int(np.bincount(ids).max()))
        cols = cs.window_columns(reqcols, rng, b"z", ids, now)
        got, gerr = eng.process_columns(cols, now)
        want, werr = ref.process_columns(cols, now)
        assert gerr == werr
        np.testing.assert_array_equal(got, want)
    assert longest > kernel_config()["chunk"]
    assert eng.metric_sorted_ticks == ref.metric_sorted_ticks == 3
    assert gt.kernel_launches()["fused_sorted_tick"] == 3
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


# The mesh's duplicate tile tick (B.6): a one-key herd over a whole
# extent, runs crossing the walk's chunk boundaries, mixed eligible and
# ineligible groups, RESET rows, expired heads, skewed extents, invalid
# lanes inside the extents and each of the five algorithms.
TILE_CASES = ([("herd", 4096), ("cross", 4096), ("mixed", 4096),
               ("mixed", 96), ("reset", 2048), ("expired", 2048),
               ("skewed", 2048), ("invalid", 700)]
              + [(a, 1024) for a in cs.ALGORITHMS])


@pytest.mark.parametrize("kind,lanes", TILE_CASES)
def test_mesh_tile_tick_matches_plain(dev, kind, lanes):
    shards, local = 4, 1024
    rng = np.random.default_rng(lanes + len(kind))
    state = cs.random_state(rng, shards * local)
    m, offs, tile = cs.tile_window(E, rng, shards, local, lanes, state, kind)
    table = sharded_table_from_columns(state, shards, local, dev)
    plain = table.clone()
    mt = torch.from_numpy(m).to(dev)
    ot = torch.from_numpy(offs).to(dev)
    rk = torch.zeros(1, dtype=torch.int64, device=dev)
    rp = torch.zeros(1, dtype=torch.int64, device=dev)
    got = mesh_tile_tick(table, mt, ot, shards, local, tile, cs.NOW, rk)
    want = mesh_tile_tick_plain(plain, mt, ot, shards, local, tile, cs.NOW,
                                rp, torch.empty_like(got))
    assert torch.equal(got, want)
    assert torch.equal(table, plain)
    assert int(rk) == int(rp)


# The run classes of B.6's steps (csrc/mesh_tile_tick.cuh): every
# tile_window kind at 700 and 2048 lanes (groups of a lane and up to a
# warp inside a warp's window, runs a warp walks, runs past 256 lanes that
# a run block takes, runs crossing chunk boundaries, invalid lanes inside
# the extents, groups that do not fold inside short runs), and tiles the
# walk never picks (groups inside a window that cross a chunk boundary,
# runs of more pieces than a run block flags at a time).
TILE_CLASS_CASES = ([(k, w, None) for k in cs.TILE_KINDS for w in (700, 2048)]
                    + [("runs", 700, 20), ("mixed", 700, 20),
                       ("invalid", 700, 20), ("runs", 2048, 4)])


def tile_kernel_and_plain(dev, m, offs, tile, state, shards, local,
                          scratch=None, tables=None):
    """B.6 and its plain version on two copies of a table (``tables`` to
    go on from): ``(got, want, rounds_kernel, rounds_plain, tables)``."""
    if tables is None:
        table = sharded_table_from_columns(state, shards, local, dev)
        tables = (table, table.clone())
    mt = torch.from_numpy(m).to(dev)
    ot = torch.from_numpy(offs).to(dev)
    rk = torch.zeros(1, dtype=torch.int64, device=dev)
    rp = torch.zeros(1, dtype=torch.int64, device=dev)
    got = mesh_tile_tick(tables[0], mt, ot, shards, local, tile, cs.NOW, rk,
                         scratch=scratch)
    want = mesh_tile_tick_plain(tables[1], mt, ot, shards, local, tile,
                                cs.NOW, rp, torch.empty_like(got))
    return got, want, int(rk), int(rp), tables


@pytest.mark.parametrize("kind,lanes,tile", TILE_CLASS_CASES)
def test_mesh_tile_tick_run_classes_match_plain(dev, kind, lanes, tile):
    shards, local = 3, 1024
    rng = np.random.default_rng(3 * lanes + len(kind))
    state = cs.random_state(rng, shards * local)
    m, offs, walk_tile = cs.tile_window(E, rng, shards, local, lanes, state,
                                        kind)
    got, want, rk, rp, (table, plain) = tile_kernel_and_plain(
        dev, m, offs, tile or walk_tile, state, shards, local)
    assert torch.equal(got, want)
    assert torch.equal(table, plain)
    assert rk == rp


def test_mesh_tile_tick_keeps_its_scratch(dev):
    """Windows one after another on one scratch (one launch each, no
    memset): each as the plain version, and the queue's counters back at
    0 after every launch."""
    from gubernator_tpu_torch.ops.tiletick import TileScratch

    shards, local, lanes = 3, 1024, 2048
    scratch = TileScratch(dev)
    tables = None
    for step, kind in enumerate(("runs", "herd", "mixed", "cross", "runs")):
        rng = np.random.default_rng(50 + step)
        state = cs.random_state(rng, shards * local)
        m, offs, tile = cs.tile_window(E, rng, shards, local, lanes, state,
                                       kind)
        got, want, rk, rp, tables = tile_kernel_and_plain(
            dev, m, offs, tile, state, shards, local, scratch, tables)
        assert torch.equal(got, want), kind
        assert torch.equal(tables[0], tables[1]), kind
        assert rk == rp, kind
        torch.cuda.synchronize()
        assert scratch.epoch == step + 1
        assert not scratch.words[:3].any()  # the counters, reset


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
    # The mesh's duplicate windows take one mesh_tile_tick launch each.
    assert launches.pop("fused_tick") == 0
    assert launches.pop("fused_merged_tick") == 0
    assert launches.pop("fused_sorted_tick") == 0
    assert launches.pop("lease_apply") == 0  # the mesh has no lease columns
    for name in GLOBAL_KERNELS:  # nor a GLOBAL mesh
        assert launches.pop(name) == 0
    assert all(v > 0 for v in launches.values())
    assert torch.equal(eng.table.cpu(), ref.table)


def test_mesh_reshard_on_the_card_matches_the_cpu_mesh(dev):
    """8 -> 3 -> 8 on a card mesh and a CPU one fed the same windows
    (unique, random and herd): equal tables and slot maps after each
    cutover (the 8 -> 3 one overflows a shard), equal answers after."""
    rng = np.random.default_rng(29)
    engs = [MeshTickEngine(n_shards=8, local_capacity=16, max_batch=64,
                           device=d) for d in (dev, "cpu")]
    now = cs.NOW

    def window(step):
        if step % 3 == 2:
            return cs.herd_columns(reqcols, b"h", rng.integers(0, 12, 64))
        return cs.window_columns(reqcols, rng, b"k",
                                 rng.integers(0, 150, 64), now)

    def same():
        card, cpu = engs
        assert torch.equal(card.table.cpu(), cpu.table)
        for a, b in zip(card.slots, cpu.slots):
            assert a.keys_batch(np.arange(card.local_capacity)) == \
                b.keys_batch(np.arange(cpu.local_capacity))
        np.testing.assert_array_equal(card._last_access, cpu._last_access)

    for n_to in (3, 8):
        for step in range(6):
            now += 500
            cols = window(step)
            got, want = (e.process_columns(cols, now) for e in engs)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
        infos = [e.reshard(n_to, now=now + 10) for e in engs]
        assert infos[0] == infos[1] and infos[0]["live_items"] > 0
        same()
    assert engs[0].metric_rank_rounds == engs[1].metric_rank_rounds


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


def test_serving_instance_on_the_card_answers_as_the_cpu_instance(dev):
    """A V1Instance on the card and one on the CPU answer the same serial
    raw batches (Zipf keys, all five algorithms, RESET and DRAIN rows,
    explicit created_at) with the same response bytes, and the same
    GLOBAL object answers."""
    import asyncio

    info = asyncio.run(cs.bitwise_instances(torch, 1 << 12, 4096, 24, 200))
    assert info["items_equal"] == 24 * 200 + 3 * 16


def test_concurrent_callers_on_the_card_keep_exact_accounting(dev):
    """Callers coalesced into shared windows by the tick loop: each key's
    drop in remaining equals the hits sent to it, whatever the windows."""
    import asyncio

    from gubernator_tpu_torch.service.instance import (
        InstanceConfig, V1Instance)
    from gubernator_tpu_torch.transport import fastwire

    rng = np.random.default_rng(77)
    keys = 2048
    payloads = [np.minimum(rng.zipf(1.2, 500) - 1, keys - 1)
                for _ in range(8)]

    async def run():
        inst = await V1Instance.create(
            InstanceConfig(cache_size=keys, tpu_max_batch=1024))
        try:
            async def call(ids, hits):
                mat, errs = await inst.get_rate_limits_columns(
                    cs.serve_columns(reqcols, b"acct", ids, hits=hits))
                assert not errs
                return mat

            async def remaining():
                return np.concatenate([(await call(np.arange(
                    s, min(s + 1000, keys)), 0))[2]
                    for s in range(0, keys, 1000)])

            before = await remaining()
            raws = [fastwire.encode_req(cs.serve_columns(reqcols, b"acct", p))
                    for p in payloads]

            async def caller(c):
                for k in range(6):
                    cols, _, _ = fastwire.parse_req(raws[(c + k) % 8],
                                                    inst.ingest_arena)
                    await inst.get_rate_limits_columns(cols)

            await asyncio.gather(*(caller(c) for c in range(16)))
            after = await remaining()
            windows = inst.engine.metric_h2d_windows
        finally:
            await inst.close()
        return before, after, windows

    before, after, windows = asyncio.run(run())
    sent = np.zeros(keys, np.int64)
    for c in range(16):
        for k in range(6):
            np.add.at(sent, payloads[(c + k) % 8], 1)
    assert windows < 4 + 16 * 6  # callers shared windows
    np.testing.assert_array_equal(before - after, sent)


def test_cluster_on_the_card_answers_as_the_cpu_cluster(dev):
    """A 3-node cluster of card engines and one of CPU engines answer the
    seeded serial sequence of ``chip_smoke.drive_cluster`` (every
    algorithm, GLOBAL items at their owner and at non-owners, RESET,
    negative hits, invalid items) alike, apart from the ``owner``
    metadata, and the union of their owner-side rows is the same."""
    import asyncio

    info = asyncio.run(cs.compare_clusters(1 << 12, 1024, 16, nodes=3))
    assert info["answers"] > 16 and info["owner_rows_equal"] > 0


def test_global_convergence_on_the_card_is_exact(dev):
    """GLOBAL hits sent to every node of a 3-node card cluster: once
    every change reached every node, each owner's count is the limit
    less the hits sent, every non-owner answers as the owner does, and
    the non-owners installed the owners' state by row scatter."""
    import asyncio

    from gubernator_tpu_torch.cluster import Cluster
    from gubernator_tpu_torch.config import BehaviorConfig

    async def run():
        c = await Cluster.start(3, cache_size=1 << 14, tpu_max_batch=1024,
                                behaviors=BehaviorConfig(
                                    batch_timeout=cs.BATCH_TIMEOUT_S,
                                    global_sync_wait=0.02))
        try:
            torch.cuda.synchronize()
            gt.reset_kernel_launches()
            out = (await cs.global_round(c, np.random.default_rng(5), 512,
                                         6))[0]
            torch.cuda.synchronize()
            return out, gt.kernel_launches()
        finally:
            await c.stop()

    out, launches = asyncio.run(run())
    assert out["owner_count_errors"] == 0
    assert out["non_owner_disagreements"] == 0
    assert out["hits"] == 6 * 1000 and min(out["owners"]) > 0
    assert launches["fused_tick"] > 0 and launches["scatter_rows"] > 0


def random_records(dev, rng, cap, neg):
    """``lease_records`` of ``cap`` slots holding random budgets (those of
    ``neg`` negative), expiries and generations, the guard entry 0."""
    from gubernator_tpu_torch.ops import leasecols as LC

    budget = rng.integers(0, 1000, cap + 1)
    budget[neg] = -5
    cols = LC.lease_records(cap, dev)
    for c, v in zip(cols, (budget, rng.integers(0, 10**6, cap + 1),
                           rng.integers(0, 99, cap + 1))):
        c.copy_(torch.from_numpy(v))
        c[cap] = 0
    return cols


def lease_copy(cols):
    from gubernator_tpu_torch.ops import leasecols as LC

    out = LC.lease_records(cols[0].shape[0] - 1, cols[0].device)
    for a, c in zip(out, cols):
        a.copy_(c)
    return out


@pytest.mark.parametrize("lanes", [1, 255, 257, 4096, 65536])
@pytest.mark.parametrize("is_set", [True, False])
def test_lease_apply_matches_plain(dev, lanes, is_set):
    """B.9 on packed lanes (repeats in the raw window, negative budgets
    outside it, from 255 lanes three slots outside the table) against the
    plain version on the same 32-B records: on the same lanes for a set
    window, on the raw lanes (the whole-column clamp) for a delta one;
    windows of one lane, around one 256-thread block and a grant call's
    and a wide window (blocks of 32 to 256 threads); the padding stays
    0."""
    from gubernator_tpu_torch.ops import leasecols as LC

    gt.reset_kernel_launches()
    rng = np.random.default_rng(lanes + is_set)
    cap = 1 << 20
    neg = rng.choice(cap, 9, replace=False)
    cols = random_records(dev, rng, cap, neg)
    raw = cs.lease_lanes(rng, cap, lanes)
    if lanes >= 255:
        raw[0][:3] = [cap, cap + 7, -1]  # lanes outside the table: dropped
    packed = torch.from_numpy(LC.pack_lanes(
        *raw, is_set, () if is_set else neg)).to(dev)
    unpacked = torch.from_numpy(np.stack([
        raw[0], raw[1], raw[2],
        np.asarray(raw[3]).astype(np.int32).astype(np.int64)])).to(dev)
    k, p = lease_copy(cols), lease_copy(cols)
    LC.lease_apply(*k, packed, is_set)
    LC.lease_apply_plain(*p, packed if is_set else unpacked, is_set)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.equal(k[0]._base, p[0]._base)  # padding included
    if not is_set:
        assert int(k[0].min()) == 0
    assert gt.kernel_launches()["lease_apply"] == 1
    assert sum(gt.kernel_launches_by_width()["lease_apply"].values()) == 1


@pytest.mark.parametrize("is_set", [True, False])
def test_lease_apply_with_every_lane_outside_the_table(dev, is_set):
    """A window whose 300 lanes all name slots outside [0, capacity)
    (the guard entry, past it, negative) writes nothing."""
    from gubernator_tpu_torch.ops import leasecols as LC

    rng = np.random.default_rng(301 + is_set)
    cap = 4096
    cols = random_records(dev, rng, cap, [])
    slots = np.concatenate([[cap, -1], rng.integers(cap, 4 * cap, 149),
                            -rng.integers(1, 1000, 149)])
    lanes = np.stack([slots, rng.integers(-50, 50, 300),
                      rng.integers(0, 10**6, 300), rng.integers(0, 9, 300)])
    k = lease_copy(cols)
    LC.lease_apply(*k, torch.from_numpy(lanes).to(dev), is_set)
    torch.cuda.synchronize()
    assert torch.equal(k[0]._base, cols[0]._base)


def test_lease_apply_refuses_separate_columns_on_the_card(dev):
    """On the card B.9 takes only ``lease_records``' views."""
    from gubernator_tpu_torch.ops import leasecols as LC

    cols = [torch.zeros(65, dtype=torch.int64, device=dev),
            torch.zeros(65, dtype=torch.int64, device=dev),
            torch.zeros(65, dtype=torch.int32, device=dev)]
    with pytest.raises(ValueError):
        LC.lease_apply(*cols, torch.zeros((4, 1), dtype=torch.int64,
                                          device=dev), True)


def test_lease_manager_on_the_card_matches_the_cpu_one(dev):
    """``chip_smoke.lease_sequence`` on a 2^14-slot card engine and on the
    same engine on the CPU: tokens, acks, stats, lease columns, probes and
    exports equal; every lease window one launch."""
    gt.reset_kernel_launches()
    out = cs.lease_compare(torch, dev)
    assert out["equal"]
    assert gt.kernel_launches()["lease_apply"] == out["lease_windows"] > 0


# ----------------------------------------------------------------------
# The GLOBAL mesh: kernels B.8a-B.8d and the engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,cap,per_node", [
    (8, 1 << 16, 256), (8, 1 << 16, 1), (3, 96, 85), (8, 1 << 10, 32)])
@pytest.mark.parametrize("touch", [False, True])
def test_global_accumulate_matches_plain(dev, n, cap, per_node, touch):
    """B.8a on sorted windows (global_mesh_8's at 8 x 2^16, a lane a node,
    255 lanes over 3 nodes) and on a window with padding lanes."""
    from gubernator_tpu_torch.ops import globalmesh as GM

    rng = np.random.default_rng(n * per_node + cap)
    m = cs.gm_window(E, rng, n, cap, per_node, min(cs.GM_KEYS, cap))
    pad = np.zeros((19, m.shape[1] + 7), np.int32)
    pad[:, :m.shape[1]] = m
    pad[E.REQ32_INDEX["slot"], m.shape[1]:] = n * cap
    for win in (m, pad):
        w = torch.from_numpy(win).to(dev)
        aux = torch.zeros((n, 9, cap), dtype=torch.int64, device=dev)
        acc = torch.zeros((n, 4, cap), dtype=torch.int64, device=dev)
        ap, cp = aux.clone(), acc.clone()
        gt.reset_kernel_launches()
        for stamp in (1, 2):
            GM.global_accumulate(w, aux, acc, n, stamp, touch)
            GM.global_accumulate_plain(w, ap, cp, n, stamp, touch)
        assert gt.kernel_launches()["global_accumulate"] == 2
        assert torch.equal(aux, ap) and torch.equal(acc, cp)


@pytest.mark.parametrize("n,cap", [(8, 1 << 16), (3, 96), (1, 64)])
@pytest.mark.parametrize("strict", [True, False])
def test_global_dense_reconcile_matches_plain(dev, n, cap, strict):
    from gubernator_tpu_torch.ops import globalmesh as GM

    rng = np.random.default_rng(n + cap + strict)
    table, aux, acc = cs.gm_random_buffers(torch, dev, rng, n, cap)
    tp, cp = table.clone(), acc.clone()
    GM.global_dense_reconcile(table, aux, acc, n, cs.NOW, strict)
    GM.global_dense_reconcile_plain(tp, aux, cp, n, cs.NOW, strict)
    assert torch.equal(table, tp) and torch.equal(acc, cp)
    assert not acc.any()


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("slice_", [300, None])
@pytest.mark.parametrize("strict", [True, False])
def test_global_dense_reconcile_tiles_match_plain(dev, n, slice_, strict):
    """B.8b's 256-slot tiles: owners' slices that end inside a tile (300
    slots), and a capacity n slots past two whole tiles (slices of
    512 / n + 1 slots)."""
    from gubernator_tpu_torch.ops import globalmesh as GM

    cap = n * slice_ if slice_ else 512 + n
    rng = np.random.default_rng(7 * n + cap + strict)
    table, aux, acc = cs.gm_random_buffers(torch, dev, rng, n, cap)
    tp, cp = table.clone(), acc.clone()
    GM.global_dense_reconcile(table, aux, acc, n, cs.NOW, strict)
    GM.global_dense_reconcile_plain(tp, aux, cp, n, cs.NOW, strict)
    assert torch.equal(table, tp) and torch.equal(acc, cp)
    assert not acc.any()


@pytest.mark.parametrize("n,cap,k,touched", [
    (8, 1 << 22, 4096, 512 / (1 << 22)), (8, 1 << 16, 4096, 0.01),
    (4, 256, 4, 0.1), (3, 96, 96, 0.5), (16, 16 << 10, 8, 0.05),
    (16, 16 << 10, 4096, 0.05), (24, 24 << 10, 16, 0.02),
    (24, 24 << 10, 4096, 0.02)])
def test_global_sparse_probe_and_apply_match_plain(dev, n, cap, k, touched):
    """B.8c's verdict, union size and union (as a set) and B.8d's rows and
    accumulators against the plain versions, at phase 9's 8 x 2^22 with
    ~512 union slots, on small meshes where the verdict overflows, and on
    16- and 24-node meshes (3n counters past one warp) both ways.  An
    overflowing union is applied whole: the grid is sized by the union
    read back with the verdict."""
    from gubernator_tpu_torch.ops import globalmesh as GM

    rng = np.random.default_rng(n + cap + k)
    if cap > 1 << 20:
        table = torch.zeros((n * cap + 1, 16), dtype=torch.int64,
                            device=dev)
        aux = torch.zeros((n, 9, cap), dtype=torch.int64, device=dev)
        acc = torch.zeros((n, 4, cap), dtype=torch.int64, device=dev)
        u = torch.from_numpy(np.sort(rng.choice(cap, 512, replace=False)))
        t2, a2, c2 = cs.gm_random_buffers(torch, dev, rng, n, 512, 1.0)
        u = u.to(dev)
        for d in range(n):
            table[d * cap + u] = t2[d * 512:(d + 1) * 512]
        aux[:, :, u] = a2
        acc[:, :, u] = c2
    else:
        table, aux, acc = cs.gm_random_buffers(torch, dev, rng, n, cap,
                                               touched)
    out, slots, scratch = GM.probe_buffers(n, cap, dev)
    po, ps, _ = GM.probe_buffers(n, cap, dev)
    for _ in range(2):  # the scratch counters are zeroed each launch
        GM.global_sparse_probe(acc, n, k, out, slots, scratch)
    GM.global_sparse_probe_plain(acc, n, k, po, ps)
    size = int(po[1])
    assert torch.equal(out, po)
    assert torch.equal(torch.sort(slots[:size]).values, ps[:size])
    tp, cp = table.clone(), acc.clone()
    GM.global_sparse_apply(table, aux, acc, n, slots, out, size, cs.NOW)
    GM.global_sparse_apply_plain(tp, aux, cp, n, ps, po, cs.NOW)
    assert torch.equal(table, tp) and torch.equal(acc, cp)


def sparse_case(dev, rng, n, cap, union, stamped=0.7, owned=False):
    """Mesh buffers whose accumulators hold windows on exactly ``union``
    random slots: each slot a window on half its nodes (one at least;
    counts 1-3, hits -5..19, RESET on a fifth; on non-owners unless
    ``owned``), a stamp on a ``stamped`` share of (node, slot) pairs
    (windows without one take the running row's parameters), every union
    slot touched by node 0.  Returns the buffers and the union's size."""
    table, aux, acc = cs.gm_random_buffers(torch, dev, rng, n, cap, 0.0)
    aux[:, 8] *= torch.from_numpy(rng.random((n, cap)) < stamped).to(dev)
    u = rng.choice(cap, union, replace=False)
    owner = u // (cap // n)
    win = rng.random((n, union)) < 0.5
    if not owned:
        win &= np.arange(n)[:, None] != owner[None, :]
    win[rng.integers(0, n, union), np.arange(union)] = True
    if not owned and n > 1:
        win[owner, np.arange(union)] = False
    a = np.zeros((n, 4, union), np.int64)
    a[:, 2] = np.where(win, rng.integers(1, 4, (n, union)), 0)
    a[:, 0] = np.where(win, rng.integers(-5, 20, (n, union)), 0)
    a[:, 1] = np.where(win & (rng.random((n, union)) < 0.2), 1, 0)
    a[:, 3] = a[:, 2] + (rng.random((n, union)) < 0.3)
    a[0, 3] = np.maximum(a[0, 3], 1)
    acc[:, :, torch.from_numpy(u).to(dev)] = torch.from_numpy(a).to(dev)
    return table, aux, acc, union


def sparse_apply_against_plain(dev, n, table, aux, acc, k=1 << 30):
    """B.8c then B.8d against the plain versions; the apply's launches."""
    from gubernator_tpu_torch.ops import globalmesh as GM

    cap = aux.shape[2]
    out, slots, scratch = GM.probe_buffers(n, cap, dev)
    GM.global_sparse_probe(acc, n, k, out, slots, scratch)
    over, size = out.tolist()
    assert not over
    tp, cp = table.clone(), acc.clone()
    gt.reset_kernel_launches()
    GM.global_sparse_apply(table, aux, acc, n, slots, out, size, cs.NOW)
    launches = gt.kernel_launches()["global_sparse_apply"]
    GM.global_sparse_apply_plain(tp, aux, cp, n, slots, out, cs.NOW)
    torch.cuda.synchronize()
    assert torch.equal(table, tp) and torch.equal(acc, cp)
    assert not acc.any()
    return size, launches


def test_global_sparse_apply_on_an_empty_union(dev):
    """A step with nothing queued: the union is empty, no launch, no row
    or accumulator touched."""
    from gubernator_tpu_torch.ops import globalmesh as GM

    rng = np.random.default_rng(90)
    table, aux, acc = cs.gm_random_buffers(torch, dev, rng, 8, 1 << 12, 0.0)
    t0 = table.clone()
    out, slots, scratch = GM.probe_buffers(8, 1 << 12, dev)
    GM.global_sparse_probe(acc, 8, 64, out, slots, scratch)
    assert out.tolist() == [0, 0]
    gt.reset_kernel_launches()
    GM.global_sparse_apply(table, aux, acc, 8, slots, out, 0, cs.NOW)
    torch.cuda.synchronize()
    assert gt.kernel_launches()["global_sparse_apply"] == 0
    assert torch.equal(table, t0) and not acc.any()


@pytest.mark.parametrize("n", [3, 8, 24])
def test_global_sparse_apply_with_windows_on_the_running_row(dev, n):
    """Every window without its own parameters (no stamp): each takes the
    running row's limit, duration, algorithm and burst, so its request is
    built and prepared on the slot's chain."""
    rng = np.random.default_rng(91 + n)
    case = sparse_case(dev, rng, n, 64 * n, 48, stamped=0.0)
    size, launches = sparse_apply_against_plain(dev, n, *case[:3])
    assert size == 48 and launches == 1


@pytest.mark.parametrize("n", [1, 2, 24, 32, 40])
def test_global_sparse_apply_on_meshes_of_one_to_forty_nodes(dev, n):
    """One node (its windows on the slots it owns), two, 24 (a warp a
    slot), 32 and 40 nodes (the chain in rounds of 32 nodes)."""
    rng = np.random.default_rng(92 + n)
    case = sparse_case(dev, rng, n, 64 * n, 40, owned=n == 1)
    size, launches = sparse_apply_against_plain(dev, n, *case[:3])
    assert size == 40 and launches == 1


@pytest.mark.parametrize("n", [4, 8, 16, 24])
@pytest.mark.parametrize("union", ["1", "3", "17", "130", "8sms+5",
                                   "16sms+9"])
def test_global_sparse_apply_grids_with_a_partial_last_block(dev, n, union):
    """Unions that leave the last block of 128 threads part full, for each
    group size the launch picks: a warp a slot (4 slots a block) up to 8
    slots an SM, 16 lanes (8 a block) up to 16, then 8 lanes (16 a block)
    where the nodes fit them."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    size = {"8sms+5": 8 * sms + 5, "16sms+9": 16 * sms + 9}.get(union)
    size = size or int(union)
    cap = n * max(256, -(-4 * size // n))
    rng = np.random.default_rng(93 + n * size)
    case = sparse_case(dev, rng, n, cap, size)
    got, launches = sparse_apply_against_plain(dev, n, *case[:3])
    assert got == size and launches == 1


def test_global_sparse_apply_at_a_loaded_union(dev):
    """Phase 2's wider B.8d shape: 8 x 2^22 slots with 4096 union slots
    (every node's windows and touches within sparse_k 4096, every owner's
    share within 2 sparse_k)."""
    rng = np.random.default_rng(94)
    table, aux, acc, *_ = cs.gm_sparse_inputs(torch, dev, rng, 8, 1 << 22,
                                              4096)
    size, launches = sparse_apply_against_plain(dev, 8, table, aux, acc,
                                                cs.GM_SPARSE_K)
    assert size == 4096 and launches == 1


@pytest.mark.parametrize("n", [16, 24])
def test_global_sparse_probe_verdict_at_its_edge(dev, n):
    """B.8c's verdict where one count decides it: the envelope one below
    and at the least k that does not overflow, on 16- and 24-node meshes
    of 4096 slots a node (the 3n counters span warps, hundreds of blocks
    finish in any order), 50 launches each, every verdict and union size
    equal to the plain version's."""
    from gubernator_tpu_torch.ops import globalmesh as GM

    cap = n << 12
    rng = np.random.default_rng(n)
    _, _, acc = cs.gm_random_buffers(torch, dev, rng, n, cap, 0.03)
    w = acc[:, GM.ACC_COUNT] > 0
    t = acc[:, GM.ACC_TOUCH] > 0
    share = (w | t).any(dim=0).view(n, cap // n).sum(dim=1)
    edge = max(int(w.sum(dim=1).max()), int(t.sum(dim=1).max()),
               (int(share.max()) + 1) // 2)
    out, slots, scratch = GM.probe_buffers(n, cap, dev)
    for k, over in ((edge - 1, 1), (edge, 0)):
        po, ps, _ = GM.probe_buffers(n, cap, dev)
        GM.global_sparse_probe_plain(acc, n, k, po, ps)
        assert int(po[0]) == over
        seen = []
        for _ in range(50):
            GM.global_sparse_probe(acc, n, k, out, slots, scratch)
            seen.append(out.clone())
        torch.cuda.synchronize()
        assert all(torch.equal(o, po) for o in seen), (k, seen[:3], po)


def test_global_mesh_card_engine_matches_the_cpu_engine(dev):
    """Phase 9 D's seeded sequence: 4 nodes at 2^14 slots, sparse_k 64 and
    0, responses and every replica's fields equal after every step."""
    from gubernator_tpu_torch import types

    gt.reset_kernel_launches()
    out = cs.global_compare(torch, dev, types)
    assert out["sparse_k_64"]["dense_fallbacks"] > 0
    launches = gt.kernel_launches()
    for name in GLOBAL_KERNELS + ("scatter_rows", "gather_rows",
                                  "fused_sorted_tick"):
        assert launches[name] > 0, name
    assert launches["fused_merged_tick"] == 0


def test_federated_cluster_on_the_card_answers_as_the_cpu_cluster(dev):
    """Phase 11 C at a smaller size: a 2-region, 4-node cluster of card
    engines and one of CPU engines on the seeded serial MULTI_REGION
    sequence of ``chip_smoke.drive_federated`` (token and leaky keys,
    explicit created_at, RESET, negative hits, one partition and heal):
    every step's answers equal, every node's final answer a key equal in
    both clusters, both regions' owners agreeing."""
    import asyncio

    info = asyncio.run(cs.compare_federated(1 << 12, 1024, 12))
    assert info["answers"] > 12 and info["final_equal_nodes"] == 4


def test_autoscaler_on_a_card_mesh_matches_the_cpu_mesh(dev):
    """An ``Autoscaler`` stepping on scripted samples drives a card mesh
    of 8 x 2^14 slots and a CPU one through its executor: one transition
    down (8 -> 4, the policy's floor) and one up (4 -> 8); after each,
    equal tables, slot maps and reclaim stamps, and equal answers to the
    same window."""
    import asyncio

    from gubernator_tpu_torch.autoscale import (
        Autoscaler, AutoscalePolicy, PolicyConfig, SignalSnapshot)
    from gubernator_tpu_torch.resilience import ManualClock

    rng = np.random.default_rng(41)
    local = 1 << 14
    engs = [MeshTickEngine(n_shards=8, local_capacity=local, max_batch=4096,
                           device=d) for d in (dev, "cpu")]
    ids = cs.route_ids(b"a", 8, [local // 2] * 8)
    now = cs.NOW
    for a in range(0, len(ids), 4096):
        cols = cs.window_columns(reqcols, rng, b"a", ids[a:a + 4096], now,
                                 prefill=True)
        got, want = (e.process_columns(cols, now) for e in engs)
        np.testing.assert_array_equal(got[0], want[0])

    def same():
        card, cpu = engs
        assert torch.equal(card.table.cpu(), cpu.table)
        for a, b in zip(card.slots, cpu.slots):
            ka = a.keys_blob(np.arange(card.local_capacity))
            kb = b.keys_blob(np.arange(cpu.local_capacity))
            assert ka[0] == kb[0] and np.array_equal(ka[1], kb[1])
        np.testing.assert_array_equal(card._last_access, cpu._last_access)

    def execute(target):
        infos = [e.reshard(target, now=now + 10) for e in engs]
        assert infos[0] == infos[1] and infos[0]["live_items"] > 0
        same()
        pick = ids[(rng.zipf(1.2, 4096) - 1) % len(ids)]
        cols = cs.window_columns(reqcols, rng, b"a", pick, now + 20)
        got, want = (e.process_columns(cols, now + 20) for e in engs)
        np.testing.assert_array_equal(got[0], want[0])
        return {"outcome": "committed", "from_shards": 0,
                "to_shards": target}

    idle = SignalSnapshot(p99_ms=0.5, hot_occupancy=0.1, shards=8)
    busy = SignalSnapshot(p99_ms=50.0, queue_depth=500, shards=4)
    feed = iter([idle, busy])
    clock = ManualClock()
    scaler = Autoscaler(
        lambda: next(feed), execute,
        policy=AutoscalePolicy(PolicyConfig(windows=1, min_shards=4,
                                            max_shards=8)),
        cooldown_up=0.0, cooldown_down=0.0, dry_run=False, clock=clock,
        sleep=clock.sleep)

    async def run():
        out = []
        for _ in range(2):
            clock.advance(10.0)
            out.append(await scaler.step())
        return out

    down, up = asyncio.run(run())
    assert (down.action, down.direction, down.to_shards) == ("act", "down", 4)
    assert (up.action, up.direction, up.to_shards) == ("act", "up", 8)
    assert engs[0].n_shards == engs[1].n_shards == 8
