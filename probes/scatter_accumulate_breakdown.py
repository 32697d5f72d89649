#!/usr/bin/env python3
"""Where the time of two kernels goes on one card: the row scatter (B.2
scatter) at the shapes the main path gives it, eviction included, and
the GLOBAL mesh's accumulate (B.8a) on global_mesh_8's windows.

    python3 probes/scatter_accumulate_breakdown.py [--out FILE]

Builds ``probes/scatter_accumulate_breakdown.cu`` (the designs those
kernels had before their Hopper redesigns, stamped copies of both, and
the port's kernels at other launch shapes; its header says what each
entry is) with the port's nvcc flags, and:

* B.2 scatter, on a (2^21 + 1, 16) random table (``chip_smoke.py`` phase
  2's): 32768 random distinct rows with a guard-row lane every 97 (phase
  2's row 3), a promote of 32768 random rows (the tiers'), and an
  eviction of 65536 zero rows (``EVICT_CHUNK``), each over 16 slot sets.
  Each is held bit for bit against ``scatter_rows_plain`` (for the
  eviction, of zero rows) first, the earlier design, the port and every
  variant, then timed in turns (earlier, port, port, earlier) and each
  variant once.  The eviction is timed as the whole call: for the
  earlier design the zero tensor's allocation and fill and the scatter
  (the earlier ``row_evict``), for the port ``rowtable.row_evict``.  The
  earlier design's stamped copy (warm: the third of three launches)
  gives each warp's slot word, source vector and store, and when the
  warps start and end.
* B.8a at 8 x 2^16 slots: global_mesh_8's windows (256 hits a node over
  4096 keys, ``chip_smoke.gm_window``) with touch off and on, and a hot
  window (256 hits a node over 16 keys), 8 windows each; held bit for
  bit against ``global_accumulate_plain`` (two windows, stamps 1 and 2),
  then timed in turns as above and the variant once; the earlier
  design's stamped copy (warm) gives each warp's column loads,
  divisions, aux stores and atomics.  Each window's lanes, queued lanes,
  tails and longest run of one slot.

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
REC = 8
R_GSTART, R_C0, R_STEP0, R_SMID, R_GEND = 0, 1, 2, 6, 7
TABLE_SLOTS = 1 << 21
ROTATE = 16
SCATTER_SHAPES = {           # rows, guard lane every k (0: none), zero rows
    "guard_32768": (32768, 97, False),
    "promote_32768": (32768, 0, False),
    "evict_65536": (65536, 0, True),
}
# The port's scatter variants (scatter_variant's `kind`): 8 rows a warp,
# plain stores, a persistent grid-stride walk.
SCATTER_VARIANTS = ("rows8", "plain_stores", "grid_stride")
GM_ROTATE = 8
ACC_WINDOWS = {              # hits a node, keys, track_touch
    "mesh8_touch_off": (256, 4096, False),
    "mesh8_touch_on": (256, 4096, True),
    "hot_16_keys": (256, 16, False),
}
ACC_THREADS = (256,)         # B.8a block sizes timed beside the port's


def _stats(v) -> dict:
    v = np.asarray(v, np.float64)
    if not len(v):
        return {"count": 0}
    return {"count": int(len(v)), "p50": float(np.median(v)),
            "p90": float(np.percentile(v, 90)), "max": float(v.max())}


def _build_probe(_build, d):
    """The probe's library, built while the port's kernels it times build
    beside it; returns it and its ``ptxas`` lines."""
    out = os.path.join(d, "scatter_accumulate_breakdown.so")
    p = subprocess.Popen(
        [_build._compiler("nvcc")] + _build.NVCC_FLAGS
        + ["-I", _build.CSRC, "-o", out,
           os.path.join(ROOT, "probes", "scatter_accumulate_breakdown.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build("rows", "global_mesh", "empty")
    log, _ = p.communicate()
    if p.returncode:
        raise RuntimeError(log)
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    return ctypes.CDLL(out), ptxas


def stamps(rec, steps) -> dict:
    """A stamped launch's warps: each step's time after the one before it
    (us, the SM clock from each finished warp's cycles over its
    globaltimer span), when warps start and end after the first start,
    and the SMs that ran them."""
    r = rec.cpu().numpy().view(np.uint64).astype(np.float64).reshape(-1, REC)
    r = r[r[:, R_GEND] > 0]
    last = R_STEP0 + len(steps) - 1
    done = r[r[:, last] > 0]
    hz = float(np.median((done[:, last] - done[:, R_C0]) / np.maximum(
        done[:, R_GEND] - done[:, R_GSTART], 1))) * 1e9
    us = 1e6 / hz
    t0 = r[:, R_GSTART].min()
    rep = {"sm_clock_mhz": hz / 1e6, "warps": int(len(r)),
           "warps_done": int(len(done)),
           "sms": int(len(np.unique(r[:, R_SMID]))),
           "start_us": _stats((r[:, R_GSTART] - t0) / 1e3),
           "end_us": _stats((r[:, R_GEND] - t0) / 1e3),
           "span_us": _stats((r[:, R_GEND] - r[:, R_GSTART]) / 1e3)}
    prev = R_C0
    for k, name in enumerate(steps):
        rep[name + "_us"] = _stats((done[:, R_STEP0 + k] - done[:, prev])
                                   * us)
        prev = R_STEP0 + k
    return rep


def scatter_part(torch, cs, lib, dev) -> dict:
    from gubernator_tpu_torch import _build
    from gubernator_tpu_torch.ops import rowtable

    stream = torch.cuda.current_stream().cuda_stream
    cap = TABLE_SLOTS
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    table = torch.randint(-2**62, 2**62, (cap + 1, 16), generator=g,
                          dtype=torch.int64, device=dev)
    table[cap] = 0
    work = table.clone()
    rng = np.random.default_rng(cs.SEED + 40)

    def prev(t, s, rows, rec=None):
        _build.check(lib.prev_scatter(
            t.data_ptr(), cap, 16, s.data_ptr(), s.numel(), rows.data_ptr(),
            rec.data_ptr() if rec is not None else None, stream),
            "prev_scatter")

    def prev_evict(t, s):
        prev(t, s, torch.zeros((s.numel(), 16), dtype=torch.int64,
                               device=dev))

    def variant(t, s, rows, kind):
        _build.check(lib.scatter_variant(
            t.data_ptr(), cap, s.data_ptr(), s.numel(),
            rows.data_ptr() if rows is not None else None,
            SCATTER_VARIANTS.index(kind), stream), "scatter_variant")

    out = {}
    for shape, (n, guard, zero) in SCATTER_SHAPES.items():
        sets = []
        for _ in range(ROTATE):
            s = torch.from_numpy(rng.choice(cap, n, replace=False)
                                 .astype(np.int64)).to(dev)
            if guard:
                s[::guard] = cap
            sets.append(s)
        rows = (torch.zeros((n, 16), dtype=torch.int64, device=dev) if zero
                else torch.from_numpy(rng.integers(-2**62, 2**62, (n, 16))
                                      .astype(np.int64)).to(dev))
        want = table.clone()
        rowtable.scatter_rows_plain(want, sets[0], rows)
        if zero:
            runs = {"earlier": lambda t, s: prev_evict(t, s),
                    "port": lambda t, s: rowtable.row_evict(t, s)}
            vrows = None
        else:
            runs = {"earlier": lambda t, s: prev(t, s, rows),
                    "port": lambda t, s: rowtable.scatter_rows(t, s, rows)}
            vrows = rows
        for v in SCATTER_VARIANTS:
            runs[v] = (lambda t, s, v=v: variant(t, s, vrows, v))
        for name, fn in runs.items():
            got = table.clone()
            fn(got, sets[0])
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"scatter {name} {shape}"
            del got
        del want

        def timed(fn):
            return cs.time_ms(torch, [lambda s=s: fn(work, s) for s in sets])

        n_live = int((sets[0] < cap).sum())
        row = {"rows": n, "live": n_live,
               "earlier_ms": [timed(runs["earlier"])],
               "port_ms": [timed(runs["port"]), timed(runs["port"])]}
        row["earlier_ms"].append(timed(runs["earlier"]))
        row["variants_ms"] = {v: timed(runs[v]) for v in SCATTER_VARIANTS}
        nbytes = n * 8 + n_live * (128 if zero else 256)
        row["bytes"] = nbytes
        row["bound_ms"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
        # The stamped earlier design, warm: the third of three launches.
        warps = int(lib.prev_scatter_warps(n, 16))
        rec = torch.zeros(warps * REC, dtype=torch.int64, device=dev)
        for _ in range(3):
            rec.zero_()
            prev(work, sets[0], rows, rec)
        torch.cuda.synchronize()
        row["stamps"] = stamps(rec, ("slot", "source", "store"))
        out[shape] = row
        del rows, sets
    return out


def window_terms(GM, w, n, cap) -> dict:
    r, d, s, live, tail, queue, reset = GM.lane_terms(w, n, cap)
    flat = (d * cap + s)[live].cpu().numpy()
    _, counts = np.unique(flat, return_counts=True)
    return {"lanes": int(w.shape[1]), "live": int(live.sum()),
            "tails": int(tail.sum()), "queued": int(queue.sum()),
            "resets": int(reset.sum()),
            "longest_run": int(counts.max()) if len(counts) else 0}


def accumulate_part(torch, cs, lib, dev) -> dict:
    from gubernator_tpu_torch import _build
    from gubernator_tpu_torch.ops import engine as E
    from gubernator_tpu_torch.ops import globalmesh as GM

    stream = torch.cuda.current_stream().cuda_stream
    n, cap = cs.GM_NODES, cs.GM_CAPACITY
    out = {}
    for shape, (per_node, keys, touch) in ACC_WINDOWS.items():
        # chip_smoke.py phase 2's generators for these windows.
        rng = np.random.default_rng(cs.SEED + 6 if keys == cs.GM_KEYS
                                    else cs.SEED + 9)
        wins = [torch.from_numpy(cs.gm_window(E, rng, n, cap, per_node, keys))
                .to(dev) for _ in range(GM_ROTATE)]

        def prev(w, a, c, stamp, rec=None):
            _build.check(lib.prev_accumulate(
                w.data_ptr(), w.stride(0), w.shape[1], a.data_ptr(),
                c.data_ptr(), n, cap, stamp, int(touch),
                rec.data_ptr() if rec is not None else None, stream),
                "prev_accumulate")

        def variant(w, a, c, stamp, threads):
            _build.check(lib.accumulate_variant(
                w.data_ptr(), w.stride(0), w.shape[1], a.data_ptr(),
                c.data_ptr(), n, cap, stamp, int(touch), threads, stream),
                "accumulate_variant")

        runs = {"earlier": prev,
                "port": lambda w, a, c, stamp: GM.global_accumulate(
                    w, a, c, n, stamp, touch)}
        for t in ACC_THREADS:
            runs[str(t)] = (lambda w, a, c, stamp, t=t: variant(w, a, c,
                                                                stamp, t))
        aux = torch.zeros((n, 9, cap), dtype=torch.int64, device=dev)
        acc = torch.zeros((n, 4, cap), dtype=torch.int64, device=dev)
        ap, cp = aux.clone(), acc.clone()
        for stamp, w in enumerate(wins[:2], 1):
            GM.global_accumulate_plain(w, ap, cp, n, stamp, touch)
        for name, fn in runs.items():
            ak, ck = aux.clone(), acc.clone()
            for stamp, w in enumerate(wins[:2], 1):
                fn(w, ak, ck, stamp)
            torch.cuda.synchronize()
            assert torch.equal(ak, ap) and torch.equal(ck, cp), \
                f"accumulate {name} {shape}"
            del ak, ck

        def timed(fn):
            return cs.time_ms(torch, [lambda w=w: fn(w, aux, acc, 3)
                                      for w in wins])

        terms = window_terms(GM, wins[0], n, cap)
        row = dict(terms, earlier_ms=[timed(runs["earlier"])],
                   port_ms=[timed(runs["port"]), timed(runs["port"])])
        row["earlier_ms"].append(timed(runs["earlier"]))
        row["threads_ms"] = {str(t): timed(runs[str(t)])
                             for t in ACC_THREADS}
        nbytes = (terms["lanes"] * 76 + terms["tails"] * 72
                  + terms["queued"] * 32 + terms["resets"] * 16
                  + (terms["live"] * 16 if touch else 0))
        row["bytes"] = nbytes
        row["bound_ms"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
        warps = int(lib.prev_accumulate_warps(wins[0].shape[1]))
        rec = torch.zeros(warps * REC, dtype=torch.int64, device=dev)
        for _ in range(3):
            rec.zero_()
            prev(wins[0], aux, acc, 3, rec)
        torch.cuda.synchronize()
        row["stamps"] = stamps(rec, ("columns", "divisions", "aux_stores",
                                     "atomics"))
        out[shape] = row
        del aux, acc, ap, cp
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scatter_accumulate_breakdown: no CUDA device available",
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
            ("prev_scatter", [vp, i64, i64, vp, i64, vp, vp, vp]),
            ("scatter_variant", [vp, i64, vp, i64, vp, c_int, vp]),
            ("prev_accumulate", [vp, i64, i64, vp, vp, i64, i64, i64, c_int,
                                 vp, vp]),
            ("accumulate_variant", [vp, i64, i64, vp, vp, i64, i64, i64,
                                    c_int, c_int, vp])):
        getattr(lib, f).argtypes = types
        getattr(lib, f).restype = c_int
    lib.prev_scatter_warps.argtypes = [i64, i64]
    lib.prev_scatter_warps.restype = i64
    lib.prev_accumulate_warps.argtypes = [i64]
    lib.prev_accumulate_warps.restype = i64
    dev = torch.device("cuda")
    report = {"card": cs.card_line(), "probe_ptxas": ptxas,
              "port_ptxas": {
                  "scatter_rows": cs.kernel_ptxas("rows", "scatter_rows"),
                  "global_accumulate": cs.kernel_ptxas(
                      "global_mesh", "accumulate_kernel")}}
    report["empty_launch_ms"] = cs.empty_launch_ms(torch, dev)
    report["b2_scatter"] = scatter_part(torch, cs, lib, dev)
    torch.cuda.empty_cache()
    report["b8a"] = accumulate_part(torch, cs, lib, dev)
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
