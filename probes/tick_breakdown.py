#!/usr/bin/env python3
"""Where the time of two kernels goes on one card: the mesh's duplicate
tile tick (B.6) on phase 4's herd window and on phase 2's ``cross``
window, and the GLOBAL mesh's dense reconcile (B.8b) at 8 x 2^16 slots.

    python3 probes/tick_breakdown.py [--out FILE]

Builds ``probes/tick_breakdown.cu`` (the one-thread designs those kernels
had before their Hopper redesigns, with a stamped copy of B.6's; its
header says what each entry is) with the port's nvcc flags, and:

* B.6: times the earlier design (memset and kernel), the port's
  ``mesh_tile_tick`` and the port's kernel built for two blocks an SM
  (its source with ``__launch_bounds__(TT_THREADS, 2)``) in turns
  (earlier, port, two, port, two, earlier) on the windows of
  ``chip_smoke.tile_entry``, each held bit for bit against
  ``mesh_tile_tick_plain`` first; runs the port's steps in a
  stamped build (``probes/tile_tick_stamps.cu``, warm: the third of
  three launches) and reports each lane-block warp's classification,
  groups and runs and each run block's runs step by step; runs the
  earlier design's stamped kernel once and reports its blocks (lane
  blocks; long blocks that found a run; long blocks that found none),
  the long runs' step cycles, and the slowest lane block's thread; and
  calibrates single-thread steps on an idle card (a transition cold and
  warm, a dependent L2 load, a fold, a 64-bit division);
* B.8b: times the earlier kernel, its move alone and its fold alone, and
  the port's ``global_dense_reconcile``, strict and not, on the
  accumulators of two ``global_mesh_8`` windows, each step's input
  restored before it and the restore timed alone and taken off
  (``chip_smoke.time_restored``).

Times are CUDA events, the median of 25 runs of 8 launches behind a ~2 ms
device sleep (``chip_smoke.time_ms``).  Prints the card line, then one
JSON object; ``--out`` also writes it to FILE.  Needs a CUDA device and
the CUDA toolkit; exits non-zero without one.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REC = 16
K = dict(start=0, end=1, cstart=2, cend=3, kind=4, work=5, heads=6,
         thread_max=7, search=8, bad=9, head=10, elig=11, fold=12, chain=13,
         pieces=14, smid=15)


def _stats(v) -> dict:
    v = np.asarray(v, np.float64)
    if not len(v):
        return {"count": 0}
    return {"count": int(len(v)), "p50": float(np.median(v)),
            "p90": float(np.percentile(v, 90)), "max": float(v.max())}


def blocks_report(rec: np.ndarray, n_long: int, clock_hz: float) -> dict:
    """The stamped kernel's per-block records read: times in us from the
    first block's start (globaltimer) or from cycles at ``clock_hz``."""
    t0 = rec[:, K["start"]].min()
    start = (rec[:, K["start"]] - t0) / 1e3
    end = (rec[:, K["end"]] - t0) / 1e3
    cyc_us = (rec[:, K["cend"]] - rec[:, K["cstart"]]) / clock_hz * 1e6
    kind = rec[:, K["kind"]]
    out = {"blocks": int(len(rec)), "long_blocks": n_long,
           "span_us": float(end.max()),
           "last_start_us": float(start.max()),
           "last_block": {"kind": int(kind[int(end.argmax())]),
                          "start_us": float(start[int(end.argmax())]),
                          "end_us": float(end.max())}}
    names = {0: "lane", 1: "long_run", 2: "long_idle"}
    for k, name in names.items():
        sel = kind == k
        out[name] = {"duration_us": _stats(cyc_us[sel]),
                     "end_us": _stats(end[sel])}
    runs = np.flatnonzero(kind == 1)
    order = runs[np.argsort(-cyc_us[runs])][:8]
    out["long_run"]["slowest"] = [
        {"run": int(rec[b, K["work"]]), "pieces": int(rec[b, K["pieces"]]),
         "us": float(cyc_us[b]), "end_us": float(end[b]),
         **{s + "_us": float(rec[b, K[s]] / clock_hz * 1e6)
            for s in ("search", "bad", "head", "elig", "fold", "chain")}}
        for b in order]
    lane = np.flatnonzero(kind == 0)
    if len(lane):
        b = lane[int(np.argmax(rec[lane, K["thread_max"]]))]
        out["lane"]["slowest_thread"] = {
            "us": float(rec[b, K["thread_max"]] / clock_hz * 1e6),
            "block_us": float(cyc_us[b]),
            "short_heads": int(rec[b, K["heads"]]),
            "longest_short_run": int(rec[b, K["work"]])}
        out["lane"]["short_heads_per_block"] = _stats(rec[lane, K["heads"]])
        out["lane"]["longest_short_run"] = int(rec[lane, K["work"]].max())
    return out


WREC, BREC = 64, 128


def stamps_report(torch, slib, tbl, mt, ot, n, local, tile, now, m, offs,
                  E) -> dict:
    """The port's steps in the stamped build (tile_tick_stamps.cu), the
    third of three launches on copies of ``tbl``: per lane-block warp its
    classification, its groups (to warp_groups' fifth barrier) and its
    runs; per run block each run's end search, flags, heads, rest and
    total, with the run's length; times in us from the first block's
    start."""
    from gubernator_tpu_torch.ops.tiletick import TileScratch

    dev = tbl.device
    b = mt.shape[1]
    nw, nb, nh = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    slib.stamped_records(b, ctypes.byref(nw), ctypes.byref(nb),
                         ctypes.byref(nh))
    wrec = torch.zeros(max(1, nw.value), dtype=torch.int64, device=dev)
    brec = torch.zeros(max(1, nb.value), dtype=torch.int64, device=dev)
    hrec = torch.zeros(max(1, nh.value), dtype=torch.int64, device=dev)
    scratch = TileScratch(dev)
    rounds = torch.zeros(1, dtype=torch.int64, device=dev)
    out = torch.empty((6, b), dtype=torch.int32, device=dev)
    # Three launches back to back, each on a fresh copy of the table (the
    # first two warm the card, as the timed runs are warm); the third's
    # stamps are kept.
    copies = [tbl.clone() for _ in range(3)]
    torch.cuda.synchronize()
    for t in copies:
        wrec.zero_()
        brec.zero_()
        hrec.zero_()
        words, epoch = scratch.take(_scratch_words(b, tile, n))
        _check(slib.stamped_tick(
            t.data_ptr(), n, local, ot.data_ptr(), mt.data_ptr(),
            mt.stride(0), out.data_ptr(), out.stride(0), b, tile, now,
            words.data_ptr(), epoch, rounds.data_ptr(), wrec.data_ptr(),
            brec.data_ptr(), hrec.data_ptr(),
            torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    w = wrec.cpu().numpy().view(np.uint64).astype(np.float64).reshape(-1, WREC)
    r = brec.cpu().numpy().view(np.uint64).astype(np.float64).reshape(-1, BREC)
    hp = hrec.cpu().numpy().view(np.uint64).astype(np.float64).reshape(-1, BREC)
    helped = hp[hp[:, -1] > 0]
    t0 = min(w[:, 0].min(), r[:, 0].min() if len(r) else np.inf)
    cnt = np.minimum(w[:, -1], WREC - 1).astype(int)
    end = np.array([row[c - 1] for row, c in zip(w, cnt)]) - t0
    classify = w[:, 1] - w[:, 0]
    groups = np.where(cnt > 6, w[:, 6] - w[:, 1], end - (w[:, 1] - t0))
    runs_us = np.where(cnt > 7, end - (w[:, 6] - t0), 0.0)
    rep = {"warps": int(len(w)),
           "warp_start_us": _stats((w[:, 0] - t0) / 1e3),
           "classify_us": _stats(classify / 1e3),
           "groups_us": _stats(groups / 1e3),
           "runs_us": _stats(runs_us / 1e3),
           "warp_end_us": _stats(end / 1e3),
           "warps_with_runs": int((cnt > 7).sum())}
    slot = m[E.REQ32_INDEX["slot"]]
    runs = []
    for row in list(r) + list(helped):
        c = min(int(row[-1]), BREC - 1)
        seq = row[:c]
        i = 1 if row[1] > 1e12 else 0
        while i + 1 < len(seq):
            pop_t, head = seq[i], int(seq[i + 1]) - 1
            j = i + 2
            stamps = []
            while j < len(seq) and seq[j] > 1e12:
                stamps.append(seq[j])
                j += 1
            if head < 0:
                break
            # the next pop's stamp is the last of these
            if j < len(seq):
                stamps = stamps[:-1]
                nxt = j - 1
            else:
                nxt = j
            length = 1
            while head + length < len(slot) and \
                    slot[head + length] == slot[head]:
                length += 1
            runs.append({
                "head": head, "lanes": length,
                "pop_us": (pop_t - t0) / 1e3,
                "start_us": (row[0] - t0) / 1e3,
                "end_search_us": (stamps[0] - pop_t) / 1e3 if stamps else None,
                "flags_us": (stamps[1] - stamps[0]) / 1e3
                if len(stamps) > 1 else None,
                "heads_us": (stamps[2] - stamps[1]) / 1e3
                if len(stamps) > 2 else None,
                "rest_us": (stamps[-1] - stamps[2]) / 1e3
                if len(stamps) > 2 else None,
                "done_us": (stamps[-1] - t0) / 1e3 if stamps else None,
                "barriers": len(stamps)})
            i = nxt
    runs.sort(key=lambda x: -x["lanes"])
    rep["run_blocks"] = int(len(r))
    rep["lane_blocks_that_helped"] = int(len(helped))
    rep["runs"] = runs[:16]
    rep["span_us"] = float(max([end.max() / 1e3]
                               + [x["done_us"] or 0.0 for x in runs]))
    return rep


def calibrate(torch, slib, dev, m) -> dict:
    """Cycles of single-thread steps on an idle card (tile_tick_stamps.cu
    calibrate_kernel): the first transition (its code cold) and each later
    one, a dependent load the L2 serves, a dependent shared-memory load, a
    fold, a 64-bit floor division."""
    slib.stamped_calibrate.restype = ctypes.c_int
    slib.stamped_calibrate.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    rng = np.random.default_rng(5)
    perm = rng.permutation(1 << 16)
    chain = np.empty(1 << 16, np.int64)
    chain[perm] = np.roll(perm, -1)
    ch = torch.from_numpy(chain * 16).to(dev)  # 128-B strides apart
    big = torch.zeros(16 << 16, dtype=torch.int64, device=dev)
    big[::16] = ch
    out = torch.zeros(7, dtype=torch.int64, device=dev)
    mt = torch.from_numpy(np.ascontiguousarray(m[:, :64])).to(dev)
    _check(slib.stamped_calibrate(big.data_ptr(), out.data_ptr(),
                                  mt.data_ptr(), mt.stride(0), 1,
                                  torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    o = out.cpu().numpy()
    return {"first_transition_cycles": float(o[0]),
            "transition_cycles": float(o[1]) / 15,
            "l2_load_cycles": float(o[2]) / 64,
            "smem_load_cycles": float(o[3]) / 16,
            "fold_cycles": float(o[4]) / 16,
            "floor_div_cycles": float(o[5]) / 16}


def _scratch_words(lanes, tile, n):
    from gubernator_tpu_torch.ops.tiletick import _lib
    return _lib().gt_mesh_tile_tick_scratch_words(lanes, tile, n)


def _check(rc):
    if rc:
        raise RuntimeError(f"stamped tick: CUDA error {rc}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tick_breakdown: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gubernator_tpu_torch import _build
    from gubernator_tpu_torch.carry import (
        sharded_table_from_columns, table_from_columns)
    from gubernator_tpu_torch.ops import engine as E
    from gubernator_tpu_torch.ops import globalmesh as GM
    from gubernator_tpu_torch.ops.raggedtick import choose_tile
    from gubernator_tpu_torch.ops.tiletick import (
        TileScratch, mesh_tile_tick, mesh_tile_tick_plain)

    print(cs.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as d:
        libs, procs = {}, {}
        # The stamped build, and (for ptxas alone) its lane and run paths
        # each on its own.
        for name, src, flags in (
                ("tick_breakdown", "tick_breakdown", []),
                ("tile_tick_stamps", "tile_tick_stamps", []),
                ("lanes_only", "tile_tick_stamps", ["-DSTAMP_LANES_ONLY"]),
                ("runs_only", "tile_tick_stamps", ["-DSTAMP_RUNS_ONLY"]),
                ("port_min2", None, [])):
            out = os.path.join(d, name + ".so")
            path = os.path.join(ROOT, "probes", f"{src}.cu")
            if src is None:  # the port's kernel, bounds for two blocks
                with open(os.path.join(_build.CSRC,
                                       "mesh_tile_tick.cu")) as fh:
                    text = fh.read()
                bounds = "__launch_bounds__(TT_THREADS, 1)"
                assert bounds in text
                path = os.path.join(d, "mesh_tile_tick_min2.cu")
                with open(path, "w") as fh:
                    fh.write(text.replace(
                        bounds, "__launch_bounds__(TT_THREADS, 2)"))
            procs[name] = (out, subprocess.Popen(
                [_build._compiler("nvcc")] + _build.NVCC_FLAGS + flags
                + ["-I", _build.CSRC, "-o", out, path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (out, p) in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                print(log, file=sys.stderr)
                return 1
            libs[name] = (ctypes.CDLL(out), log)
        lib, build_log = libs["tick_breakdown"]
        slib, stamps_log = libs["tile_tick_stamps"]
        min2 = libs["port_min2"][0]
    vp, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.prev_tick.restype = c_int
    lib.prev_tick.argtypes = [vp, i64, i64, vp, vp, i64, vp, i64, i64, i64,
                              i64, vp, vp, vp, vp]
    lib.prev_tick_blocks.restype = i64
    lib.prev_tick_blocks.argtypes = [i64]
    lib.prev_dense.restype = c_int
    lib.prev_dense.argtypes = [vp, vp, vp, i64, i64, i64, c_int, c_int, vp]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for f, types in (("gt_mesh_tile_tick", [vp, i64, i64, vp, vp, i64, vp,
                                           i64, i64, i64, i64, vp, i64, vp,
                                           vp]),
                     ("gt_mesh_tile_tick_scratch_words", [i64, i64, i64])):
        getattr(min2, f).argtypes = types
    min2.gt_mesh_tile_tick.restype = c_int
    min2.gt_mesh_tile_tick_scratch_words.restype = i64
    slib.stamped_tick.restype = c_int
    slib.stamped_tick.argtypes = [vp, i64, i64, vp, vp, i64, vp, i64, i64,
                                  i64, i64, vp, i64, vp, vp, vp, vp, vp]
    slib.stamped_records.argtypes = [i64, vp, vp, vp]
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, (_, log) in libs.items()}
    report = {"card": cs.card_line(), "ptxas": ptxas}

    # ---- B.6 ----
    rng = np.random.default_rng(cs.SEED)
    n, L, lanes = cs.TILE_SHARDS, cs.TILE_LOCAL, cs.TILE_LANES
    herds = [cs.herd_tile_window(E, rng, n, L, lanes) for _ in range(4)]
    touched = np.unique(np.concatenate([h[2] for h in herds]))
    table = torch.zeros((n * (L + 1), 16), dtype=torch.int64, device=dev)
    prefill = np.zeros((len(touched), 16), np.int64)
    for f, v in (("algorithm", 0), ("limit", 100), ("remaining", 99),
                 ("duration", 3_600_000), ("created_at", cs.NOW - 1_000),
                 ("expire_at", cs.NOW + 3_599_000), ("in_use", 1)):
        prefill[:, E.WORD[f]] = v
    flat = touched + touched // L
    table[torch.from_numpy(flat).to(dev)] = torch.from_numpy(prefill).to(dev)
    tile = choose_tile(lanes, n)
    crng = np.random.default_rng(cs.SEED + 7)
    cstate = cs.random_state(crng, n * cs.TILE_CROSS_LOCAL)
    cm, coffs, ctile = cs.tile_window(E, crng, n, cs.TILE_CROSS_LOCAL,
                                      cs.TILE_CROSS_LANES, cstate, "cross")
    ctable = sharded_table_from_columns(cstate, n, cs.TILE_CROSS_LOCAL, dev)

    def prev_call(tbl, mt, ot, local, tl, out, cnt, recs=None):
        b = mt.shape[1]
        scratch = torch.empty(max(1, n * -(-b // tl)), dtype=torch.int32,
                              device=dev)
        _build.check(lib.prev_tick(
            tbl.data_ptr(), n, local, ot.data_ptr(), mt.data_ptr(),
            mt.stride(0), out.data_ptr(), out.stride(0), b, tl, cs.NOW,
            scratch.data_ptr(), cnt.data_ptr(),
            recs.data_ptr() if recs is not None else None, stream),
            "prev_tick")
        return out

    windows = {"herd": (table, herds[0][0], herds[0][1], L, tile),
               "cross": (ctable, cm, coffs, cs.TILE_CROSS_LOCAL, ctile)}
    b6 = {}
    for what, (tbl, m, offs, local, tl) in windows.items():
        mt = torch.from_numpy(m).to(dev)
        ot = torch.from_numpy(offs).to(dev)
        b = mt.shape[1]
        t_p, t_o, t_n = tbl.clone(), tbl.clone(), tbl.clone()
        r = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(3)]
        want = mesh_tile_tick_plain(t_p, mt, ot, n, local, tl, cs.NOW, r[0],
                                    torch.empty((6, b), dtype=torch.int32,
                                                device=dev))
        got_o = prev_call(t_o, mt, ot, local, tl,
                          torch.empty((6, b), dtype=torch.int32, device=dev),
                          r[1])
        got_n = mesh_tile_tick(t_n, mt, ot, n, local, tl, cs.NOW, r[2])
        torch.cuda.synchronize()
        for name, got, t_x, r_x in (("earlier", got_o, t_o, r[1]),
                                    ("port", got_n, t_n, r[2])):
            assert torch.equal(got, want), f"{what} {name}: response"
            assert torch.equal(t_x, t_p), f"{what} {name}: table"
            assert int(r_x) == int(r[0]), f"{what} {name}: rounds"
        if what == "herd":
            dwins = [(torch.from_numpy(h[0]).to(dev),
                      torch.from_numpy(h[1]).to(dev)) for h in herds]
        else:
            dwins = [(mt, ot)]
        work = tbl.clone()
        outs = [torch.empty((6, b), dtype=torch.int32, device=dev)
                for _ in dwins]
        cnt = torch.zeros(1, dtype=torch.int64, device=dev)
        earlier = [lambda x=x, o=o: prev_call(work, *x, local, tl, o, cnt)
                   for x, o in zip(dwins, outs)]
        scr = TileScratch(dev)
        port = [lambda x=x, o=o: mesh_tile_tick(work, *x, n, local, tl,
                                                cs.NOW, cnt, out=o,
                                                scratch=scr)
                for x, o in zip(dwins, outs)]
        scr2 = TileScratch(dev)

        def call_min2(x, o):
            words, epoch = scr2.take(min2.gt_mesh_tile_tick_scratch_words(
                b, tl, n))
            _build.check(min2.gt_mesh_tile_tick(
                work.data_ptr(), n, local, x[1].data_ptr(), x[0].data_ptr(),
                x[0].stride(0), o.data_ptr(), o.stride(0), b, tl, cs.NOW,
                words.data_ptr(), epoch, cnt.data_ptr(), stream),
                "mesh_tile_tick (two blocks an SM)")

        t_2 = tbl.clone()
        r_2 = torch.zeros(1, dtype=torch.int64, device=dev)
        got_2 = torch.empty((6, b), dtype=torch.int32, device=dev)
        words, epoch = scr2.take(min2.gt_mesh_tile_tick_scratch_words(
            b, tl, n))
        _build.check(min2.gt_mesh_tile_tick(
            t_2.data_ptr(), n, local, ot.data_ptr(), mt.data_ptr(),
            mt.stride(0), got_2.data_ptr(), got_2.stride(0), b, tl, cs.NOW,
            words.data_ptr(), epoch, r_2.data_ptr(), stream), "min2")
        torch.cuda.synchronize()
        assert torch.equal(got_2, want) and torch.equal(t_2, t_p), \
            f"{what}: the two-blocks build differs"
        port2 = [lambda x=x, o=o: call_min2(x, o)
                 for x, o in zip(dwins, outs)]
        b6[what] = {"lanes": b, "tile": tl, "rounds": int(r[0]),
                    "earlier_ms": [cs.time_ms(torch, earlier)],
                    "port_ms": [cs.time_ms(torch, port)],
                    "port_min2_ms": [cs.time_ms(torch, port2)]}
        b6[what]["port_ms"].append(cs.time_ms(torch, port))
        b6[what]["port_min2_ms"].append(cs.time_ms(torch, port2))
        b6[what]["earlier_ms"].append(cs.time_ms(torch, earlier))
        b6[what]["port_stamps"] = stamps_report(
            torch, slib, tbl, mt, ot, n, local, tl, cs.NOW, m, offs, E)
        # The earlier design's stamped run, once, on a fresh copy.
        blocks = int(lib.prev_tick_blocks(b))
        recs = torch.zeros((blocks, REC), dtype=torch.int64, device=dev)
        t_s = tbl.clone()
        prev_call(t_s, mt, ot, local, tl,
                  torch.empty((6, b), dtype=torch.int32, device=dev),
                  torch.zeros(1, dtype=torch.int64, device=dev), recs)
        torch.cuda.synchronize()
        rec = recs.cpu().numpy().view(np.uint64).astype(np.float64)
        clock_hz = _sm_clock_hz(rec)
        b6[what]["sm_clock_mhz"] = clock_hz / 1e6
        b6[what]["blocks"] = blocks_report(rec, b // 33, clock_hz)
        slots = m[E.REQ32_INDEX["slot"], :int(offs[-1])]
        _, counts = np.unique(slots, return_counts=True)
        b6[what]["runs"] = {
            "distinct": int(len(counts)), "longest": int(counts.max()),
            "le_1": int((counts == 1).sum()),
            "2_32": int(((counts > 1) & (counts <= 32)).sum()),
            "33_256": int(((counts > 32) & (counts <= 256)).sum()),
            "gt_256": int((counts > 256).sum()),
            "lanes_in_gt_256": int(counts[counts > 256].sum())}
    report["b6"] = b6
    report["calibration"] = calibrate(torch, slib, dev, herds[0][0])
    report["empty_launch_ms"] = cs.empty_launch_ms(torch, dev)

    # ---- B.8b ----
    gn, cap = cs.GM_NODES, cs.GM_CAPACITY
    wins = [torch.from_numpy(cs.gm_window(E, rng, gn, cap, cs.GM_BATCH,
                                          cs.GM_KEYS)).to(dev)
            for _ in range(2)]
    aux = torch.zeros((gn, 9, cap), dtype=torch.int64, device=dev)
    acc = torch.zeros((gn, 4, cap), dtype=torch.int64, device=dev)
    for stamp, w in enumerate(wins, 1):
        GM.global_accumulate(w, aux, acc, gn, stamp, False)
    tbl = table_from_columns(cs.random_state(rng, gn * cap), gn * cap, dev)
    work = acc.clone()

    def restore():
        work.copy_(acc)

    b8 = {"slots": cap, "nodes": gn,
          "windows_folded": int((acc[:, GM.ACC_COUNT] > 0).sum())}
    for strict in (1, 0):
        tk, ck, tp, cp = tbl.clone(), acc.clone(), tbl.clone(), acc.clone()
        GM.global_dense_reconcile(tk, aux, ck, gn, cs.NOW, bool(strict))
        _build.check(lib.prev_dense(tp.data_ptr(), aux.data_ptr(),
                                    cp.data_ptr(), gn, cap, cs.NOW, strict, 0,
                                    stream), "prev_dense")
        torch.cuda.synchronize()
        assert torch.equal(tk, tp) and torch.equal(ck, cp), \
            f"dense reconcile: port differs from the earlier kernel ({strict})"
        row = {}

        def prev(mode, s=strict):
            return lambda: _build.check(lib.prev_dense(
                tbl.data_ptr(), aux.data_ptr(), work.data_ptr(), gn, cap,
                cs.NOW, s, mode, stream), "prev_dense")

        port = (lambda s=strict: GM.global_dense_reconcile(
            tbl, aux, work, gn, cs.NOW, bool(s)))
        row["earlier_ms"] = [cs.time_restored(torch, [prev(0)],
                                              [restore])["ms"]]
        row["port_ms"] = [cs.time_restored(torch, [port], [restore])["ms"]
                          for _ in range(2)]
        row["earlier_ms"].append(cs.time_restored(torch, [prev(0)],
                                                  [restore])["ms"])
        row["earlier_move_ms"] = cs.time_restored(torch, [prev(1)],
                                                  [restore])["ms"]
        row["earlier_fold_ms"] = cs.time_restored(torch, [prev(2)],
                                                  [restore])["ms"]
        b8["strict" if strict else "summed"] = row
    b8["bytes"] = cap * (128 + gn * 8 + gn * 128 + gn * 32)
    b8["bytes_bound_ms"] = b8["bytes"] / cs.HBM_BYTES_PER_S * 1e3
    report["b8b"] = b8
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


def _sm_clock_hz(rec: np.ndarray) -> float:
    """The SM clock during the stamped run (Hz): the median of cycles over
    globaltimer nanoseconds of the blocks that ran for 2 us or more."""
    ns = rec[:, K["end"]] - rec[:, K["start"]]
    cyc = rec[:, K["cend"]] - rec[:, K["cstart"]]
    sel = ns >= 2000
    return float(np.median(cyc[sel] / ns[sel]) * 1e9) if sel.any() else 1.98e9


if __name__ == "__main__":
    sys.exit(main())
