#!/usr/bin/env python3
"""B5 (csrc/extend.cu) of this checkout against another checkout's, on
one card: the one-warp body (W <= 63) and the wide body (W >= 64).

    python3 tools/torch_extend_ab.py --base DIR [--reps 5]
    python3 tools/torch_extend_ab.py --sweep [--reps 3]

DIR is the root of another checkout of this repository, for example
the parent commit unpacked into a directory that .gitignore lists:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent

Each checkout builds its own kernel extension (in its own
build/torch_ext/) and, in a process of its own, times extz and extd on
chip_smoke.py phase 6's pairs and widths: W = 63, 31, 64 and 255 on
8,192 pairs, W = 5,000 on the first 1,024 (CUDA events, the mean of
--reps calls after one warm-up call), in the order base, this, this,
base; the outputs of every run must be equal. Prints the card's
name and power limit, the registers, stack frame and spills of every
extend.cu instance of both checkouts (`nvcc -Xptxas -v`), each run's
times beside the bound chip_smoke.py computes, and as its last line one
JSON object.

--sweep times this checkout's wide body alone on the same pairs at
each number of warps a pair (1, 2, 4, 8), with the pairs in the wrapper's
order (most band cells first) and in input order, at W = 64 and 255 on
2,048-8,192 pairs and W = 5,000 on 1,024-4,096: the measurements behind
ops/extend_cuda.wide_warps and wide_order. Every variant's outputs must
equal the wrapper's own choice. Imports nothing of JAX or of the JAX
package.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (W, mode, pairs)
RUNS = tuple((W, m, b) for W, b in ((63, 8192), (31, 8192), (64, 8192),
                                    (255, 8192), (5000, 1024))
             for m in ("extz", "extd"))
GAPS = {"extz": {}, "extd": {"gapo2": 24, "gape2": 1}}
ZDROP = 400


def worker(root, data, out, reps):
    """Time this root's kernels on the pairs in `data`; write the times
    (JSON) and the outputs (npz) next to `out`."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from longqc_tpu_torch.ops import _ext
    from longqc_tpu_torch.ops import extend as ext
    if not os.path.abspath(ext.__file__).startswith(os.path.abspath(root)):
        raise AssertionError("imported %s, not from %s" % (ext.__file__,
                                                          root))
    dev = torch.device("cuda:0")
    with np.load(data) as z:
        args = [torch.from_numpy(z[k]).to(dev)
                for k in ("q", "ql", "t", "tl")]
    t = time.time()
    _ext.lib()
    build_s = time.time() - t
    res, outs = {"build_s": build_s}, {}
    for W, mode, b in RUNS:
        def run():
            return ext.extz_batch(*(a[:b] for a in args), W=W, zdrop=ZDROP,
                                  **GAPS[mode])
        got = run()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            run()
        t1.record()
        torch.cuda.synchronize()
        res["%s_W%d" % (mode, W)] = t0.elapsed_time(t1) / reps
        outs["%s_W%d" % (mode, W)] = np.stack(
            [got[k].cpu().numpy().astype(np.int32) for k in ext.KEYS])
    np.savez(out + ".npz", **outs)
    with open(out, "w") as f:
        json.dump(res, f)


def pretty(symbol):
    """`lq_extend_kernel<2, true>` from a mangled B5 symbol, else None."""
    m = re.search(r"(lq_extend(?:_wide)?_kernel)I(.*?)EEv", symbol)
    if not m:
        return None
    targs = [str(int(x)) if k == "i" else ("true" if x == "1" else "false")
             for k, x in re.findall(r"L([ib])(\d+)E", m.group(2) + "E")]
    return "%s<%s>" % (m.group(1), ", ".join(targs))


def run_all(roots, tmp, q, ql, t, tl, reps):
    """Each checkout's worker in the order base, this, this, base ->
    ([(label, times)], [outputs]); every run's outputs equal."""
    import numpy as np
    data = os.path.join(tmp, "pairs.npz")
    np.savez(data, q=q, ql=ql, t=t, tl=tl)
    times, outs = [], []
    for i, label in enumerate(("base", "this", "this", "base")):
        out = os.path.join(tmp, "run%d.json" % i)
        t0 = time.time()
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", roots[label], "--data", data, "--out",
                        out, "--reps", str(reps)], check=True)
        with open(out) as f:
            r = json.load(f)
        times.append((label, r))
        with np.load(out + ".npz") as z:
            outs.append({k: z[k] for k in z.files})
        print("run %d (%s): %s; process %.1f s" % (
            i, label, json.dumps({k: round(v, 4) for k, v in r.items()}),
            time.time() - t0), flush=True)
    for o in outs[1:]:
        for k in o:
            if not np.array_equal(o[k], outs[0][k]):
                raise AssertionError("%s: outputs differ between runs" % k)
    return times, outs


SWEEP = ((64, 8192), (255, 8192), (255, 4096), (255, 2048), (5000, 1024),
         (5000, 2048), (5000, 4096))


def sweep(pairs, reps):
    """This checkout's wide body at each (W, pairs) of SWEEP, extz and
    extd, for each warps-a-pair value and pair order -> {key: ms}."""
    import torch
    import chip_smoke as cs
    from longqc_tpu_torch.ops import extend as ext
    from longqc_tpu_torch.ops import extend_cuda as ec
    args = [torch.from_numpy(a).cuda() for a in pairs]
    policy, order = ec.wide_warps, ec.wide_order

    def in_order(ql, tl, Lt, Wa):
        return torch.arange(ql.shape[0], dtype=torch.int32, device=ql.device)

    res = {}
    try:
        for W, b in SWEEP:
            a = [x[:b] for x in args]
            Wa = min(W, max(int(a[1].max()), a[2].shape[1]))
            for mode, gap in GAPS.items():
                ec.wide_warps, ec.wide_order = policy, order
                want = ext.extz_batch(*a, W=W, zdrop=ZDROP, **gap)
                for G in (1, 2, 4, 8):
                    for sort in (True, False):
                        ec.wide_warps = lambda B, Wa, G=G: G
                        ec.wide_order = order if sort else in_order

                        def run():
                            return ext.extz_batch(*a, W=W, zdrop=ZDROP, **gap)
                        got = run()
                        for key in ext.KEYS:
                            if not torch.equal(got[key], want[key]):
                                raise AssertionError("%s W=%d B=%d G=%d: %s "
                                                     "differs" % (mode, W, b,
                                                                  G, key))
                        ms = cs.cuda_ms(run, reps)
                        key = "%s_W%d_B%d_G%d_%s" % (
                            mode, W, b, G, "sorted" if sort else "input")
                        res[key] = ms
                        print("%s W=%d B=%d: %d warps a pair, %s order: %.4f "
                              "ms%s" % (mode, W, b, G, "sorted" if sort
                                        else "input", ms,
                                        " (the wrapper's choice)" if sort and
                                        G == policy(b, Wa) else ""),
                              flush=True)
    finally:
        ec.wide_warps, ec.wide_order = policy, order
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="root of the checkout to compare with")
    ap.add_argument("--sweep", action="store_true",
                    help="time this checkout's wide body's variants")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        return worker(a.worker, a.data, a.out, a.reps)
    if not a.base and not a.sweep:
        ap.error("--base or --sweep is required")
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    import chip_smoke as cs
    from util_synth import make_genome_fast
    card = cs.card_line()
    print("card: %s" % card, flush=True)
    # chip_smoke.py phase 6's pairs: the same seed, genome and draws
    rng = np.random.RandomState(31)
    genome = make_genome_fast(rng, 10_000_000)
    q, ql, t, tl = cs.extension_pairs(rng, genome, 8192, 500, 4000, 0.12,
                                      0.2)
    if a.sweep:
        res = sweep((q, ql, t, tl), a.reps)
        print(card)
        print(json.dumps({"card": card, "sweep": res}))
        return
    base = os.path.abspath(a.base)
    roots = {"base": base, "this": HERE}
    res_all = {}
    for label, root in roots.items():
        src = os.path.join(root, "longqc_tpu_torch", "csrc", "extend.cu")
        res = cs.ptxas_resources(src, pretty)
        res_all[label] = {k: v for k, v in sorted(res.items())}
        for k, v in sorted(res.items()):
            print("%s %s: %d registers, %d bytes stack frame, spills %d / %d "
                  "bytes" % (label, k, v["registers"], v["stack"],
                             v["spill_stores"], v["spill_loads"]),
                  flush=True)

    with tempfile.TemporaryDirectory(prefix="extend_ab_") as tmp:
        times, outs = run_all(roots, tmp, q, ql, t, tl, a.reps)
    summary = {}
    for W, mode, b in RUNS:
        key = "%s_W%d" % (mode, W)
        o = outs[0][key]
        in_bytes = 4 * (q[:b].size + t[:b].size + 2 * b)
        out_bytes = b * (7 * 4 + 1)
        cols = np.where(o[7] != 0, o[2].astype(np.int64) + 1, tl[:b])
        cells = int((np.clip(cols, 0, None)
                     * np.minimum(ql[:b].astype(np.int64), 2 * W + 1)).sum())
        b_ms, b_by = cs.bound(in_bytes + out_bytes,
                              cells * cs.OPS_PER_CELL[mode])
        ms = {lab: [r[key] for lb, r in times if lb == lab] for lab in roots}
        summary[key] = {"base_ms": ms["base"], "this_ms": ms["this"],
                        "bound_ms": b_ms, "bound_by": b_by, "cells": cells,
                        "zdropped": int((o[7] != 0).sum())}
        print("B5 %s W=%d: base %s ms, this %s ms; bound %.4f ms (%s, %d "
              "band cells); %d of %d Z-dropped" % (
                  mode, W, " / ".join("%.4f" % x for x in ms["base"]),
                  " / ".join("%.4f" % x for x in ms["this"]), b_ms, b_by,
                  cells, summary[key]["zdropped"], b), flush=True)
    print(card)
    print(json.dumps({"card": card, "runs": summary, "resources": {
        lab: {k: v for k, v in r.items()} for lab, r in res_all.items()}}))


if __name__ == "__main__":
    main()
