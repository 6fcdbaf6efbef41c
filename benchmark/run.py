"""The benchmark of the PyTorch + CUDA port (longqc_tpu_torch) on the
card: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), device
and, traced, breakdown; then `checks`, each compared number beside its
limit, which the last lines of standard error repeat. Without a CUDA
device the run exits 2 and prints no result.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness
    harness.cache_dirs()
    manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = harness.cell_of(manifest, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print("no CUDA device, or fewer than the %d the cell asks for: "
              "nothing measured" % cell["chips"], file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    res = harness.run_cell(args.workload, args.seed, args.seconds,
                           args.trace, device="cuda", t_start=T_START,
                           manifest=manifest)
    bad = harness.forbidden_modules()
    if bad:
        print("loaded in this run, and forbidden: %s" % ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print("check %s = %r (limit %r)" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
