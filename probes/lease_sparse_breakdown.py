#!/usr/bin/env python3
"""Where the time of two kernels goes on one card: the quota-lease column
window (B.9) on a grant call's window and on a wide one, and the GLOBAL
mesh's sparse fold and install (B.8d) at 8 x 2^22 slots with 512 to
4096 union slots.

    python3 probes/lease_sparse_breakdown.py [--out FILE]

Builds ``probes/lease_sparse_breakdown.cu`` (the designs those kernels
had before their Hopper redesigns, stamped copies of both, and the port's
kernels at other launch shapes; its header says what each entry is) with
the port's nvcc flags, and:

* B.9, on a 10M-slot column triple (``chip_smoke.lease_entry``'s; the
  earlier design on three columns, the port on ``lease_records``'
  records holding the same values): set and delta windows of 4096 raw
  lanes (a grant call's, ~3840 packed) and of 65536, each held bit for
  bit against ``lease_apply_plain`` first (the earlier design, the
  port's ``lease_apply``, and the port's kernel at 256-thread blocks),
  then timed in turns (earlier, port, port, earlier) and 256-thread
  blocks once; the
  earlier design's stamped copy (warm: the third of three launches)
  gives each warp's slot-load, lane-load and column-load steps and its
  stores; the window's 32-B sectors a column and a record (distinct
  sectors) and the bound of moving them (``sector_bound_ms``,
  ``record_sector_bound_ms``); an empty launch;
* B.8d, on ``chip_smoke.gm_sparse_inputs`` at 8 x 2^22 with 512, 1024,
  2048 and 4096 union slots and the port's probe (B.8c) for the union list: the earlier
  design (a grid of 2 n sparse_k threads, the count read on the card),
  the port's ``global_sparse_apply`` and the port's kernel at 8, 16 and
  32 lanes a slot, held bit for bit against the plain version, then
  timed in turns (earlier, port, port, earlier; each group size once)
  with each
  step's accumulators restored before it and the restore taken off
  (``chip_smoke.time_restored``); the earlier design's stamped copy
  (warm) gives each union slot's list word, row, count reads, each
  window's loads and transition and its stores, and each block's span
  (the blocks past the union read the count and exit); a stamped copy of
  the port's design (warm) gives each union slot's list word, its
  accumulator words and row, its windows' aux words, the prepares, the
  chain and the stores.

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
REC9 = 8
RECD, RECD_NODES, RECD_WINS, RECB, RECS = 64, 16, 16, 4, 16
D = dict(gstart=0, gend=1, c0=2, list=3, row=4, stores=5, wins=6, smid=7,
         count=8, win=8 + RECD_NODES)
LEASE_RAW = (4096, 65536)   # raw lanes of a window (a grant call's; wide)
# B.9 block sizes timed beside the port's choice
LEASE_THREADS = (256,)
# B.8d lanes a union slot
GROUPS = (8, 16, 32)
UNIONS = (512, 1024, 2048, 4096)


def _stats(v) -> dict:
    v = np.asarray(v, np.float64)
    if not len(v):
        return {"count": 0}
    return {"count": int(len(v)), "p50": float(np.median(v)),
            "p90": float(np.percentile(v, 90)), "max": float(v.max())}


def _build_probe(_build, d):
    """The probe's library, built while the port's kernels it times
    build beside it; returns it and its ``ptxas`` lines."""
    out = os.path.join(d, "lease_sparse_breakdown.so")
    p = subprocess.Popen(
        [_build._compiler("nvcc")] + _build.NVCC_FLAGS
        + ["-I", _build.CSRC, "-o", out,
           os.path.join(ROOT, "probes", "lease_sparse_breakdown.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build("lease_apply", "global_mesh", "empty")
    log, _ = p.communicate()
    if p.returncode:
        raise RuntimeError(log)
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    return ctypes.CDLL(out), ptxas


def sectors(slots: np.ndarray, width: int) -> int:
    """Distinct 32-B sectors of a column of ``width``-byte entries that
    ``slots`` touch."""
    return int(len(np.unique(slots * width // 32)))


def lease_part(torch, cs, lib, dev) -> dict:
    from gubernator_tpu_torch import _build
    from gubernator_tpu_torch.ops import leasecols as LC

    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(cs.SEED + 5)
    cap = cs.LEASE_SLOTS

    def col(v, dtype):
        t = torch.from_numpy(np.asarray(v, dtype)).to(dev)
        t[cap] = 0
        return t

    neg = rng.choice(cap, cs.LEASE_NEGATIVE, replace=False)
    budget = col(rng.integers(0, 1000, cap + 1), np.int64)
    budget[torch.from_numpy(neg).to(dev)] = -5
    # The earlier design's three columns (the port's records are made
    # from them, lease_records).
    cols = (budget, col(cs.NOW + rng.integers(0, 10**6, cap + 1), np.int64),
            col(rng.integers(0, 1000, cap + 1), np.int32))
    work = [c.clone() for c in cols]
    work_r = LC.lease_records(cap, dev)
    for r, c in zip(work_r, cols):
        r.copy_(c)

    def ptrs(c):
        return c[0].data_ptr(), c[1].data_ptr(), c[2].data_ptr()

    def prev(c, lanes, is_set, rec=None):
        _build.check(lib.prev_lease(
            *ptrs(c), cap, lanes.data_ptr(), lanes.shape[1], int(is_set),
            rec.data_ptr() if rec is not None else None, stream),
            "prev_lease")

    def variant(r, lanes, is_set, threads):
        _build.check(lib.lease_variant(
            r[0].data_ptr(), cap, lanes.data_ptr(), lanes.shape[1],
            int(is_set), threads, stream), "lease_variant")

    def fresh_records():
        r = LC.lease_records(cap, dev)
        for a, c in zip(r, cols):
            a.copy_(c)
        return r

    out = {}
    for raw_n in LEASE_RAW:
        for is_set in (True, False):
            kind = "set" if is_set else "delta"
            raws = [cs.lease_lanes(rng, cap, raw_n) for _ in range(16)]
            packed = [torch.from_numpy(LC.pack_lanes(
                *r, is_set, () if is_set else neg)).to(dev) for r in raws]
            lanes = packed[0]
            want = [c.clone() for c in cols]
            LC.lease_apply_plain(*want, lanes, is_set)
            got = [c.clone() for c in cols]
            prev(got, lanes, is_set)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b), f"B.9 earlier {kind} {raw_n}"
            del got
            runs = {"port": lambda r: LC.lease_apply(*r, lanes, is_set)}
            for v in LEASE_THREADS:
                runs[str(v)] = (lambda r, v=v: variant(r, lanes, is_set, v))
            for name, fn in runs.items():
                got = fresh_records()
                fn(got)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert torch.equal(a, b), f"B.9 {name} {kind} {raw_n}"
                assert not got[0]._base[:, 3].any(), "B.9 padding"
            del want, got

            def timed(fn, c):
                return cs.time_ms(torch, [lambda p=p: fn(c, p)
                                          for p in packed])

            e_fn = (lambda c, p: prev(c, p, is_set))
            p_fn = (lambda r, p: LC.lease_apply(*r, p, is_set))
            row = {"raw_lanes": raw_n, "lanes": int(lanes.shape[1]),
                   "earlier_ms": [timed(e_fn, work)],
                   "port_ms": [timed(p_fn, work_r)]}
            row["port_ms"].append(timed(p_fn, work_r))
            row["earlier_ms"].append(timed(e_fn, work))
            row["threads_ms"] = {
                str(v): timed(lambda r, p, v=v: variant(r, p, is_set, v),
                              work_r)
                for v in LEASE_THREADS}
            # The stamped earlier design, warm: the third of three launches.
            warps = int(lib.prev_lease_warps(lanes.shape[1]))
            rec = torch.zeros(warps * REC9, dtype=torch.int64, device=dev)
            for _ in range(3):
                rec.zero_()
                prev(work, lanes, is_set, rec)
            torch.cuda.synchronize()
            r = rec.cpu().numpy().view(np.uint64).astype(np.float64)
            r = r.reshape(-1, REC9)
            r = r[r[:, 7] > 0]
            hz = float(np.median((r[:, 5] - r[:, 1]) / np.maximum(
                r[:, 7] - r[:, 0], 1))) * 1e9
            us = 1e6 / hz
            t0 = r[:, 0].min()
            row["stamps"] = {
                "sm_clock_mhz": hz / 1e6, "warps": int(len(r)),
                "start_us": _stats((r[:, 0] - t0) / 1e3),
                "end_us": _stats((r[:, 7] - t0) / 1e3),
                "slot_load_us": _stats((r[:, 2] - r[:, 1]) * us),
                "lane_load_us": _stats((r[:, 3] - r[:, 2]) * us),
                "column_load_us": _stats((r[:, 4] - r[:, 3]) * us),
                "stores_us": _stats((r[:, 5] - r[:, 4]) * us),
                "sms": int(len(np.unique(r[:, 6])))}
            s = lanes[LC.SLOT].cpu().numpy()
            sec = {"budget": sectors(s, 8), "expire": sectors(s, 8),
                   "gen": sectors(s, 4)}
            lane_bytes = int(lanes.shape[1]) * 32
            twice = 1 if is_set else 2
            row["sectors"] = dict(sec, per_lane=sum(sec.values())
                                  / int(lanes.shape[1]),
                                  records=sectors(s, 32))
            row["sector_bound_ms"] = (lane_bytes + sum(sec.values()) * 32
                                      * twice) / cs.HBM_BYTES_PER_S * 1e3
            row["record_sector_bound_ms"] = (
                lane_bytes + sectors(s, 32) * 32 * twice) \
                / cs.HBM_BYTES_PER_S * 1e3
            row["bytes_bound_ms"] = int(lanes.shape[1]) * (
                28 + 20 + (0 if is_set else 20)) / cs.HBM_BYTES_PER_S * 1e3
            out[f"{kind}_{raw_n}"] = row
    return out


def sparse_part(torch, cs, lib, dev) -> dict:
    from gubernator_tpu_torch import _build
    from gubernator_tpu_torch.ops import globalmesh as GM

    stream = torch.cuda.current_stream().cuda_stream
    n, big, k = cs.GM_NODES, cs.GM_SPARSE_CAPACITIES[1], cs.GM_SPARSE_K
    max_slots = 2 * n * k
    out = {}
    for union in UNIONS:
        rng = np.random.default_rng(cs.SEED + 60 + union)
        table, aux, acc, ut, acc_u, accu = cs.gm_sparse_inputs(
            torch, dev, rng, n, big, union)
        po, ps, pscr = GM.probe_buffers(n, big, dev)
        GM.global_sparse_probe(acc, n, k, po, ps, pscr)
        over, size = po.tolist()
        assert over == 0 and size == union, (over, size)
        count = po[1:]

        def prev(t, a, srec=None, brec=None):
            _build.check(lib.prev_apply(
                t.data_ptr(), aux.data_ptr(), a.data_ptr(), n, big,
                ps.data_ptr(), count.data_ptr(), max_slots, cs.NOW,
                srec.data_ptr() if srec is not None else None,
                brec.data_ptr() if brec is not None else None, stream),
                "prev_apply")

        def port(t, a):
            GM.global_sparse_apply(t, aux, a, n, ps, po, size, cs.NOW)

        def variant(t, a, g):
            _build.check(lib.apply_variant(
                t.data_ptr(), aux.data_ptr(), a.data_ptr(), n, big,
                ps.data_ptr(), size, cs.NOW, g, stream), "apply_variant")

        tp, cp = table.clone(), acc.clone()
        GM.global_sparse_apply_plain(tp, aux, cp, n, ps, po, cs.NOW)
        runs = {"earlier": prev, "port": port}
        for g in GROUPS:
            runs[str(g)] = (lambda t, a, g=g: variant(t, a, g))
        for name, fn in runs.items():
            te, ce = table.clone(), acc.clone()
            fn(te, ce)
            torch.cuda.synchronize()
            assert torch.equal(te, tp) and torch.equal(ce, cp), \
                f"B.8d {name} {union}"
            del te, ce
        del tp, cp

        def restore():
            acc[:, :, ut] = acc_u

        row = {"nodes": n, "slots": big, "union": union,
               "windows": int((accu[:, 2] > 0).sum()),
               "own_parameters": int(((accu[:, 2] > 0) & (
                   aux[:, 8][:, ut].cpu().numpy() > 0)).sum())}
        def timed(fn):
            return cs.time_restored(torch, [lambda: fn(table, acc)],
                                    [restore])

        e = [timed(prev)]
        row["port_ms"] = [timed(port)["ms"] for _ in range(2)]
        e.append(timed(prev))
        row["earlier_ms"] = [x["ms"] for x in e]
        row["restore_ms"] = e[0]["restore_ms"]
        row["groups_ms"] = {
            str(g): timed(lambda t, a, g=g: variant(t, a, g))["ms"]
            for g in GROUPS}
        # The stamped earlier design, warm: the third of three launches.
        blocks = int(lib.prev_apply_blocks(max_slots))
        srec = torch.zeros(union * RECD, dtype=torch.int64, device=dev)
        brec = torch.zeros(blocks * RECB, dtype=torch.int64, device=dev)
        for _ in range(3):
            restore()
            srec.zero_()
            brec.zero_()
            prev(table, acc, srec, brec)
        restore()
        torch.cuda.synchronize()
        row["stamps"] = stamps_report(
            srec.cpu().numpy().view(np.uint64).astype(np.float64)
            .reshape(-1, RECD),
            brec.cpu().numpy().view(np.uint64).astype(np.float64)
            .reshape(-1, RECB), n)
        row["port_stamps"] = port_stamps(torch, lib, dev, table, aux, acc,
                                         ps, size, n, big, cs.NOW, restore,
                                         stream)
        out[str(union)] = row
        del table, aux, acc
        torch.cuda.empty_cache()
    return out


def sparse_group(n: int, count: int, sms: int) -> int:
    """Lanes a union slot the port's launch picks (csrc/global_mesh.cu
    sparse_group)."""
    least = 8 if n <= 8 else 16 if n <= 16 else 32
    g = 8 if count > 16 * sms else 16 if count > 8 * sms else 32
    return max(g, least)


def port_stamps(torch, lib, dev, table, aux, acc, ps, size, n, big, now,
                restore, stream) -> dict:
    """The port's B.8d steps from its stamped copy at the lanes a slot the
    port picks, warm (the third of three launches): per union slot the
    list word, the accumulator words and row, the aux words of the
    windows, the prepares, the chain and the stores, in us, and when the
    slots end after the first one starts."""
    from gubernator_tpu_torch import _build

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = sparse_group(n, size, sms)
    rec = torch.zeros(size * RECS, dtype=torch.int64, device=dev)
    for _ in range(3):
        restore()
        rec.zero_()
        _build.check(lib.apply_port_stamped(
            table.data_ptr(), aux.data_ptr(), acc.data_ptr(), n, big,
            ps.data_ptr(), size, now, g, rec.data_ptr(), stream),
            "apply_port_stamped")
    restore()
    torch.cuda.synchronize()
    r = rec.cpu().numpy().view(np.uint64).astype(np.float64).reshape(-1,
                                                                     RECS)
    hz = float(np.median((r[:, 8] - r[:, 2]) / np.maximum(
        r[:, 1] - r[:, 0], 1))) * 1e9
    us = 1e6 / hz
    t0 = r[:, 0].min()
    steps = ("list", "acc_and_row", "aux", "prepare", "chain", "stores")
    rep = {"lanes_a_slot": g, "sm_clock_mhz": hz / 1e6,
           "windows_per_slot": _stats(r[:, 9]),
           "sms": int(len(np.unique(r[:, 10]))),
           "start_us": _stats((r[:, 0] - t0) / 1e3),
           "end_us": _stats((r[:, 1] - t0) / 1e3),
           "total_us": _stats((r[:, 8] - r[:, 2]) * us)}
    for k, name in enumerate(steps):
        rep[name + "_us"] = _stats((r[:, 3 + k] - r[:, 2 + k]) * us)
    return rep


def stamps_report(s: np.ndarray, b: np.ndarray, n: int) -> dict:
    """The stamped earlier B.8d read: per union slot its steps in us (the
    SM clock from its cycles over its globaltimer span), per block its
    span; times from the first block's start."""
    hz = float(np.median((s[:, D["stores"]] - s[:, D["c0"]])
                         / np.maximum(s[:, D["gend"]] - s[:, D["gstart"]],
                                      1))) * 1e9
    us = 1e6 / hz
    t0 = b[:, 0].min()
    wins = s[:, D["wins"]].astype(int)
    counts = s[:, D["count"]:D["count"] + min(n, RECD_NODES)]
    rep = {"sm_clock_mhz": hz / 1e6, "slots": int(len(s)),
           "windows_per_slot": _stats(wins),
           "list_us": _stats((s[:, D["list"]] - s[:, D["c0"]]) * us),
           "row_us": _stats((s[:, D["row"]] - s[:, D["list"]]) * us),
           "row_to_last_count_us": _stats((counts[:, -1] - s[:, D["row"]])
                                          * us),
           "total_us": _stats((s[:, D["stores"]] - s[:, D["c0"]]) * us),
           "slot_span_us": _stats((s[:, D["gend"]] - s[:, D["gstart"]])
                                  / 1e3),
           "slot_end_us": _stats((s[:, D["gend"]] - t0) / 1e3)}
    # Each step's time after the step before it, in the thread's order:
    # the row, then per node its count read, and for a window its loads
    # and its transition; the stores after the last of them.
    steps = {"count": [], "load": [], "trans": []}
    stores = []
    nc = min(n, RECD_NODES)
    for row, w in zip(s, wins):
        pairs = row[D["win"]:D["win"] + 2 * min(w, RECD_WINS)].reshape(-1, 2)
        ev = sorted([(row[D["row"]], "row")]
                    + [(x, "count") for x in row[D["count"]:D["count"] + nc]]
                    + [(a, "load") for a, _ in pairs]
                    + [(z, "trans") for _, z in pairs])
        for (t_prev, _), (t, kind) in zip(ev, ev[1:]):
            steps[kind].append((t - t_prev) * us)
        stores.append((row[D["stores"]] - ev[-1][0]) * us)
    rep["count_read_us"] = _stats(steps["count"])
    rep["window_loads_us"] = _stats(steps["load"])
    rep["transition_us"] = _stats(steps["trans"])
    rep["stores_us"] = _stats(stores)
    work = b[:, 2] > 0
    rep["blocks"] = {
        "total": int(len(b)), "with_slots": int(work.sum()),
        "idle_span_us": _stats((b[~work, 1] - b[~work, 0]) / 1e3),
        "idle_end_us": _stats((b[~work, 1] - t0) / 1e3),
        "idle_last_start_us": float((b[~work, 0] - t0).max() / 1e3)
        if (~work).any() else None,
        "work_end_us": _stats((b[work, 1] - t0) / 1e3),
        "sms_with_slots": int(len(np.unique(b[work, 3])))}
    return rep


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lease_sparse_breakdown: no CUDA device available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gubernator_tpu_torch import _build

    print(cs.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as d:
        lib, ptxas = _build_probe(_build, d)
    vp, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for f, types in (
            ("prev_lease", [vp, vp, vp, i64, vp, i64, c_int, vp, vp]),
            ("lease_variant", [vp, i64, vp, i64, c_int, c_int, vp]),
            ("apply_variant", [vp, vp, vp, i64, i64, vp, i64, i64, c_int,
                               vp]),
            ("prev_apply", [vp, vp, vp, i64, i64, vp, vp, i64, i64, vp, vp,
                            vp]),
            ("apply_port_stamped", [vp, vp, vp, i64, i64, vp, i64, i64,
                                    c_int, vp, vp])):
        getattr(lib, f).argtypes = types
        getattr(lib, f).restype = c_int
    for f in ("prev_lease_warps", "prev_apply_blocks"):
        getattr(lib, f).argtypes = [i64]
        getattr(lib, f).restype = i64
    dev = torch.device("cuda")
    report = {"card": cs.card_line(), "probe_ptxas": ptxas,
              "port_ptxas": {
                  "lease_apply": cs.kernel_ptxas("lease_apply",
                                                 "lease_apply_kernel"),
                  "global_sparse_apply": {
                      f"lanes_{g}": cs.kernel_ptxas(
                          "global_mesh", f"apply_kernelILi{g}E")
                      for g in GROUPS}}}
    report["b9"] = lease_part(torch, cs, lib, dev)
    report["empty_launch_ms"] = cs.empty_launch_ms(torch, dev)
    report["b8d"] = sparse_part(torch, cs, lib, dev)
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
