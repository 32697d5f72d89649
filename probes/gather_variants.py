#!/usr/bin/env python3
"""Time variants of the row gather on one card, beside the port's own.

    python3 probes/gather_variants.py

Builds ``probes/gather_variants.cu`` with the port's nvcc flags and times
each variant (its header comment says what each one is) and the port's
``rowtable.gather_rows`` on 16-word rows of a 2^21-slot random table at
4096, 32768, 312500 and 625000 random distinct slots, as
``chip_smoke.py`` phase 2 times the gather: CUDA events, the median of 25
runs of 8 launches behind a ~2 ms device sleep, rotating over 16 slot
sets; each variant timed twice, in the order listed then reversed.
Every variant is first held bit for bit against ``gather_rows_plain`` on
a slot set with negative and past-the-end slots.  Prints the card line,
then one JSON line a shape (microseconds), then the empty-launch time.
Needs a CUDA device and the CUDA toolkit; exits non-zero without one.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("v_flat", "v_w1_ldg", "v_w2_ldg", "v_w4_ldg", "v_w8_ldg",
            "v_w1_na", "v_w2_na", "v_w4_na", "v_w8_na", "v_w2_nc",
            "v_w8_nc_cs", "v_w2_l2", "v_w2_ldg_cs", "v_p2_x4", "v_p2_x8")
SHAPES = (4096, 32768, 312500, 625000)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gubernator_tpu_torch import _build
    from gubernator_tpu_torch.ops import rowtable

    print(cs.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as d:
        lib_path = os.path.join(d, "gather_variants.so")
        subprocess.run(
            [_build._compiler("nvcc")] + _build.NVCC_FLAGS
            + ["-o", lib_path, os.path.join(ROOT, "probes",
                                            "gather_variants.cu")],
            check=True, capture_output=True)
        lib = ctypes.CDLL(lib_path)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    fns = {}
    for name in VARIANTS:
        f = getattr(lib, name)
        f.restype, f.argtypes = ctypes.c_int, [vp, i64, i64, vp, i64, vp, vp]
        fns[name] = f
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    cap = 1 << 21
    table = torch.from_numpy(rng.integers(
        -2**62, 2**62, (cap + 1, 16)).astype(np.int64)).to(dev)
    stream = torch.cuda.current_stream().cuda_stream
    for n in SHAPES:
        sets = [torch.from_numpy(rng.choice(cap, n, replace=False).astype(
            np.int64)).to(dev) for _ in range(16)]
        chk = sets[0].clone()
        chk[::97] = -3
        chk[1::97] = cap + 5
        want = rowtable.gather_rows_plain(table, chk)
        out = torch.empty((n, 16), dtype=torch.int64, device=dev)

        def call(f, s):
            _build.check(f(table.data_ptr(), cap, 16, s.data_ptr(), n,
                           out.data_ptr(), stream), "gather variant")
        for name, f in fns.items():
            out.zero_()
            call(f, chk)
            torch.cuda.synchronize()
            assert torch.equal(out, want), (name, n)
        assert torch.equal(rowtable.gather_rows(table, chk), want)
        times = {name: [] for name in ("port",) + VARIANTS}
        for name in ("port",) + VARIANTS + VARIANTS[::-1] + ("port",):
            if name == "port":
                fs = [lambda s=s: rowtable.gather_rows(table, s) for s in sets]
            else:
                fs = [lambda s=s, f=fns[name]: call(f, s) for s in sets]
            times[name].append(cs.time_ms(torch, fs) * 1e3)
        print(json.dumps({"rows": n, "bound_us": n * 264 / cs.HBM_BYTES_PER_S
                          * 1e6, "us": times}), flush=True)
    print(json.dumps({"empty_launch_us": cs.empty_launch_ms(torch, dev) * 1e3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
