"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels build
with ``nvcc`` at first use); without one they skip.  They cover shapes the
main path does not reach in ``chip_smoke.py``: widths that are not a
multiple of a block, column slices, rows narrower than 16 words,
out-of-range and guard-row slots, and the engine on a tiny table that
fills and reclaims.  They import nothing of JAX, so they run where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import gubernator_tpu_torch as gt
from gubernator_tpu_torch.carry import table_from_columns
from gubernator_tpu_torch.ops import engine as E
from gubernator_tpu_torch.ops import reqcols, rowtable
from gubernator_tpu_torch.ops.fusedtick import fused_tick, fused_tick_plain

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
    for step in range(8):
        now += 700
        ids = rng.integers(0, 90, 48) if step % 2 else rng.permutation(48)
        cols = cs.window_columns(reqcols, rng, b"k", ids, now)
        got, gerr = eng.process_columns(cols, now)
        want, werr = ref.process_columns(cols, now)
        assert gerr == werr
        np.testing.assert_array_equal(got, want)
    assert eng.metric_rank_rounds > 0 and eng.metric_unexpired_evictions > 0
    assert all(v > 0 for v in gt.kernel_launches().values())
    assert torch.equal(eng.table.cpu(), ref.table)
