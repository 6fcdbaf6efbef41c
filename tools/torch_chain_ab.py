#!/usr/bin/env python3
"""B2 (csrc/chain.cu) of this checkout against another checkout's, on
one card.

    python3 tools/torch_chain_ab.py --base DIR [--reps 3]
    python3 tools/torch_chain_ab.py --sweep [--reps 3]

DIR is the root of another checkout of this repository, for example
the parent commit unpacked into a directory that .gitignore lists:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent

The rows are chip_smoke.py's (`rand_anchor_rows`: targets of 40-400
anchors, repeat-dense and (AT)n-like rows) at the shapes SHAPES: phase
3's Q=128 A=8192 with one table and with a table a row, the wide rungs'
64 x 2^19 (chip_smoke.WIDE_CHAIN) and 32 x 2^20. Each checkout builds
its own kernel extension (in its own build/torch_ext/) and, in a
process of its own, times `chain_dp_fill` on every shape (CUDA events,
the mean of --reps calls after one warm-up call), in the order base,
this, this, base; f, p and v of every run must be equal. Prints the
card's name and power limit, the registers, stack frame and spills of
both checkouts' B2 (`nvcc -Xptxas -v`), each run's times, and as its
last line one JSON object.

--sweep times this checkout alone at each value of
ops/chain_cuda.WARPS_PER_SM in SWEEP_WARPS (the pieces a row follow),
each run's outputs equal to the default's: the measurement behind the
constant. Imports nothing of JAX or of the JAX package.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, Q, A, a table a row)
SHAPES = (("q128_a8192", 128, 8192, False),
          ("q128_a8192_rowtab", 128, 8192, True),
          ("q64_a2p19", 64, 1 << 19, False),
          ("q32_a2p20", 32, 1 << 20, False))
SWEEP_WARPS = (4, 8, 16, 32, 64, 128)


def rows(Q, A):
    """chip_smoke.rand_anchor_rows at (Q, A), seeded by the shape."""
    import numpy as np
    import chip_smoke as cs
    return cs.rand_anchor_rows(np.random.RandomState(Q + A), Q, A)


def tables(Q, per_row):
    import numpy as np
    from longqc_tpu_torch.ops.chain import gap_penalty_table
    avg = [12 + r / 7 for r in range(Q)] if per_row else [12]
    return np.stack([gap_penalty_table(np.float32(a), 500) for a in avg])


def worker(root, data, out, reps, warps):
    """Time this root's B2 on the rows in `data` (one npz a shape);
    write the times and the digests of f / p / v (JSON) to `out`."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from longqc_tpu_torch.ops import _ext
    from longqc_tpu_torch.ops import chain_cuda as cc
    if not os.path.abspath(cc.__file__).startswith(os.path.abspath(root)):
        raise AssertionError("imported %s, not from %s" % (cc.__file__,
                                                          root))
    if warps:
        cc.WARPS_PER_SM = warps
    dev = torch.device("cuda:0")
    t = time.time()
    _ext.lib()
    res, outs = {"build_s": time.time() - t}, {}
    dig = hashlib.sha256
    for name, Q, A, _ in SHAPES:
        with np.load(os.path.join(data, name + ".npz")) as z:
            axh, axl, aq, nb, pen = (torch.from_numpy(z[k]).to(dev) for k in
                                     ("axh", "axl", "aq", "nb", "pen"))
        span = torch.full((Q, A), 12, dtype=torch.int32, device=dev)

        def run():
            return cc.chain_dp_fill(axh, axl, aq, span, nb, pen, bw=500)
        got = run()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            run()
        t1.record()
        torch.cuda.synchronize()
        res[name] = t0.elapsed_time(t1) / reps
        outs[name] = dig(b"".join(o.cpu().numpy().tobytes()
                                  for o in got)).hexdigest()
        del axh, axl, aq, nb, pen, span, got
        torch.cuda.empty_cache()
    with open(out, "w") as f:
        json.dump({"ms": res, "digests": outs}, f)


def run_worker(root, data, tmp, i, reps, warps=0):
    out = os.path.join(tmp, "run%d.json" % i)
    t0 = time.time()
    subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                    root, "--data", data, "--out", out, "--reps", str(reps),
                    "--warps", str(warps)], check=True)
    with open(out) as f:
        r = json.load(f)
    return r["ms"], r["digests"], time.time() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="root of the checkout to compare with")
    ap.add_argument("--sweep", action="store_true",
                    help="time this checkout at each WARPS_PER_SM")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--warps", type=int, default=0, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        return worker(a.worker, a.data, a.out, a.reps, a.warps)
    if not a.base and not a.sweep:
        ap.error("--base or --sweep is required")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    import chip_smoke as cs
    card = cs.card_line()
    print("card: %s" % card, flush=True)
    summary = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chain_ab_") as tmp:
        t = time.time()
        for name, Q, A, per_row in SHAPES:
            axh, axl, aq, nb = rows(Q, A)
            np.savez(os.path.join(tmp, name + ".npz"), axh=axh, axl=axl,
                     aq=aq, nb=nb, pen=tables(Q, per_row))
        print("rows made in %.1f s" % (time.time() - t), flush=True)
        if a.sweep:
            ref, res = None, {}
            for i, warps in enumerate(SWEEP_WARPS):
                r, o, wall = run_worker(HERE, tmp, tmp, i, a.reps, warps)
                if ref is None:
                    ref = run_worker(HERE, tmp, tmp, 99, 1)[1]
                if o != ref:
                    raise AssertionError("outputs at %d warps an SM differ"
                                         % warps)
                res[warps] = r
                print("%d warps an SM: %s; process %.1f s" % (
                    warps, json.dumps({k: round(v, 4) for k, v in r.items()}),
                    wall), flush=True)
            summary["sweep"] = res
        else:
            roots = {"base": os.path.abspath(a.base), "this": HERE}
            for label, root in roots.items():
                res = cs.ptxas_resources(
                    os.path.join(root, "longqc_tpu_torch", "csrc",
                                 "chain.cu"),
                    lambda s: "lq_chain" if "lq_chain" in s else None)
                for k, v in res.items():
                    print("%s %s: %d registers, %d bytes stack frame, spills "
                          "%d / %d bytes" % (label, k, v["registers"],
                                             v["stack"], v["spill_stores"],
                                             v["spill_loads"]), flush=True)
                summary.setdefault("resources", {})[label] = res
            times, outs = [], []
            for i, label in enumerate(("base", "this", "this", "base")):
                r, o, wall = run_worker(roots[label], tmp, tmp, i, a.reps)
                times.append((label, r))
                outs.append(o)
                print("run %d (%s): %s; process %.1f s" % (
                    i, label, json.dumps({k: round(v, 4)
                                          for k, v in r.items()}), wall),
                      flush=True)
            if any(o != outs[0] for o in outs[1:]):
                raise AssertionError("f, p, v differ between runs")
            for name, Q, A, _ in SHAPES:
                ms = {lab: [r[name] for lb, r in times if lb == lab]
                      for lab in roots}
                summary[name] = {"base_ms": ms["base"], "this_ms": ms["this"]}
                print("B2 %s: base %s ms, this %s ms, %.1fx" % (
                    name, " / ".join("%.4f" % x for x in ms["base"]),
                    " / ".join("%.4f" % x for x in ms["this"]),
                    sum(ms["base"]) / sum(ms["this"])), flush=True)
    print(card)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
