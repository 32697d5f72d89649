#!/usr/bin/env python3
"""Where the merged tick's time goes on one NVIDIA GPU (kernel B.3).

    python3 scripts/merged_tick_split.py [--against CHECKOUT]

Run from the root of a checkout.  On ``chip_smoke.merged_window`` heads
(16 windows over a 2^21-slot random table, each window's first 512, 4096
or 8192 heads) it times, with ``chip_smoke.time_ms``:

* an empty kernel of a grid of 128-thread blocks, one thread a head;
* a copy kernel of the merged tick's memory work: each head's request
  words, group size and row in, the row and a zero journal row out;
* this checkout's merged tick on mixed heads, on token-, leaky- and
  zoo-only heads and with every group size 1, and the same built with
  32-lane tiles of 192 threads (a copy of ``csrc/`` with the tile sizes
  changed); with ``--against``, that checkout's merged tick on the same
  windows;
* the one-thread-a-head design with ``%globaltimer`` stamps of thread 0
  of each block (``scripts/merged_tick_split.cu``, built on the
  ``--against`` checkout's ``transition.cuh`` when one is given, else on
  this one's): the median block's time from entry to its request words,
  its row, the transition, the fold and its stores issued.

Every timed kernel is first held against the plain version bit for bit.
Prints the card line and one JSON line.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = (512, 4096, 8192)
KINDS = ("mixed", "token", "leaky", "zoo", "count1")
STAMPS = ("request_in_ns", "row_in_ns", "transition_ns", "fold_ns",
          "stores_issued_ns")


def nvcc(build_dir, name, include, source):
    """``source`` built with the port's nvcc flags against ``include``."""
    from gubernator_tpu_torch import _build

    out = os.path.join(build_dir, name + ".so")
    cmd = ([_build._compiler("nvcc")] + _build.NVCC_FLAGS
           + ["-I", include, "-o", out, source])
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"building {name} failed:\n{p.stdout}{p.stderr}")
    return ctypes.CDLL(out), [
        ln.strip() for ln in (p.stdout + p.stderr).splitlines()
        if "registers" in ln or "spill" in ln]


def tile32_source(build_dir, csrc):
    """A copy of ``csrc`` whose tiles hold 32 lanes in 192 threads."""
    dst = os.path.join(build_dir, "tile32_csrc")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    path = os.path.join(dst, "tile.cuh")
    with open(path) as fh:
        text = fh.read()
    for a, b in (("constexpr int TILE = 64;", "constexpr int TILE = 32;"),
                 ("constexpr int TILE_THREADS = 256;",
                  "constexpr int TILE_THREADS = 192;")):
        if a not in text:
            raise RuntimeError(f"tile.cuh has no '{a}'")
        text = text.replace(a, b)
    with open(path, "w") as fh:
        fh.write(text)
    return dst


def merged_fn(lib):
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    fn = lib.gt_fused_merged_tick
    fn.restype, fn.argtypes = ctypes.c_int, [vp, i64, vp, i64, vp, vp, i64,
                                             i64, vp]
    return fn


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="CHECKOUT",
                    help="another checkout: its merged tick is timed too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("merged_tick_split: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gubernator_tpu_torch import _build
    from gubernator_tpu_torch.carry import table_from_columns
    from gubernator_tpu_torch.ops import engine as E
    from gubernator_tpu_torch.ops.fusedtick import (
        MERGED24_W, fused_merged_tick, fused_merged_tick_plain)

    dev = torch.device("cuda")
    bdir = os.path.join(_build.BUILD_DIR, "merged_tick_split")
    os.makedirs(bdir, exist_ok=True)
    stamp_csrc = (os.path.join(os.path.abspath(args.against),
                               "gubernator_tpu_torch", "csrc")
                  if args.against else _build.CSRC)
    diag, ptx_diag = nvcc(bdir, "diag", stamp_csrc, os.path.join(
        ROOT, "scripts", "merged_tick_split.cu"))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    diag.diag_empty.argtypes = [i64, vp]
    diag.diag_copy.argtypes = [vp, i64, vp, i64, vp, vp, i64, vp]
    diag.diag_stamped.argtypes = [vp, i64, vp, i64, vp, vp, i64, i64, vp, vp]
    t32_csrc = tile32_source(bdir, _build.CSRC)
    t32_lib, ptx_t32 = nvcc(bdir, "tile32", t32_csrc,
                            os.path.join(t32_csrc, "fused_merged_tick.cu"))
    fns = {"tile32": merged_fn(t32_lib)}
    if args.against:
        fns["against"] = cs.build_against(args.against)["fused_merged_tick"]

    rng = np.random.default_rng(cs.SEED)
    cap = 1 << 21
    state = cs.random_state(rng, cap)
    heads = [cs.merged_window(E, rng, cap, max(WIDTHS), state)
             for _ in range(16)]
    live = heads[0][2]
    table = table_from_columns(state, cap, dev)

    def variant(kind):
        ws = []
        for m, c, _ in heads:
            if kind in ("token", "leaky", "zoo"):
                m, c = cs.merged_single(E, rng, m, c, live, kind)
            elif kind == "count1":
                c = np.ones_like(c)
            ws.append((torch.from_numpy(m).to(dev),
                       torch.from_numpy(c).to(dev)))
        return ws

    wins = {kind: variant(kind) for kind in KINDS}
    stream = torch.cuda.current_stream().cuda_stream

    def launch(name, work, jr, x, w):
        if name == "this":
            fused_merged_tick(work, x[0][:, :w], x[1][:w], cs.NOW, out=jr[:w])
        else:
            fns[name](work.data_ptr(), cap, x[0].data_ptr(), x[0].stride(0),
                      x[1].data_ptr(), jr.data_ptr(), w, cs.NOW, stream)

    for name in ["this"] + list(fns):   # bit for bit, whole windows
        for kind, ws in wins.items():
            mh, c = ws[0]
            t_k, t_p = table.clone(), table.clone()
            j_k = torch.empty((mh.shape[1], MERGED24_W), dtype=torch.int32,
                              device=dev)
            launch(name, t_k, j_k, ws[0], mh.shape[1])
            j_p = fused_merged_tick_plain(t_p, mh, c, cs.NOW,
                                          torch.empty_like(j_k))
            torch.cuda.synchronize()
            if not (torch.equal(j_k, j_p) and torch.equal(t_k, t_p)):
                raise AssertionError(f"{name} on {kind} heads differs")
            del t_k, t_p

    work = table.clone()
    jr = torch.empty((max(WIDTHS), MERGED24_W), dtype=torch.int32, device=dev)
    res = {"card": cs.card_line(), "heads_live_of_8192": int(live),
           "ptxas": {"diag": ptx_diag, "tile32": ptx_t32}}
    for w in WIDTHS:
        r = {"empty": cs.time_ms(torch, lambda: diag.diag_empty(w, stream)),
             "copy": cs.time_ms(torch, [
                 lambda x=x: diag.diag_copy(
                     work.data_ptr(), cap, x[0].data_ptr(), x[0].stride(0),
                     x[1].data_ptr(), jr.data_ptr(), w, stream)
                 for x in wins["mixed"]])}

        def timed(name, kind):
            return cs.time_ms(torch, [
                lambda x=x: launch(name, work, jr, x, w)
                for x in wins[kind]])

        # 64- and 32-lane tiles on the mixed heads in turns: 32, 64, 64, 32
        a = timed("tile32", "mixed")
        r["this"] = {"mixed": [timed("this", "mixed"),
                               timed("this", "mixed")]}
        r["tile32"] = {"mixed": [a, timed("tile32", "mixed")]}
        for kind in KINDS[1:]:
            r["this"][kind] = timed("this", kind)
        if "against" in fns:
            r["against"] = {kind: timed("against", kind) for kind in KINDS}
        segs = []
        blocks = (w + 127) // 128
        for rep in range(9):
            x = wins["mixed"][rep]
            sp = torch.zeros((blocks, 6), dtype=torch.int64, device=dev)
            torch.cuda._sleep(cs.SLEEP_CYCLES)
            diag.diag_stamped(work.data_ptr(), cap, x[0].data_ptr(),
                              x[0].stride(0), x[1].data_ptr(), jr.data_ptr(),
                              w, cs.NOW, sp.data_ptr(), stream)
            torch.cuda.synchronize()
            segs.append(np.median(np.diff(sp.cpu().numpy(), axis=1), axis=0))
        r["stamps_one_thread_a_head"] = dict(
            zip(STAMPS, np.median(segs, axis=0).tolist()))
        res[str(w)] = r
    print(res["card"])
    print("merged_tick_split " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
