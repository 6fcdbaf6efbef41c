"""Readings that the limits of `correct` are set from, on the card:

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

For each seed, at the cell's own size: one job of the program, judged
as a run judges it (the program's readings, the lower ends), and the
control put in the program's place, judged the same way (the upper
ends). The control is the reference computed in float32 where the
configuration states float64: meanQ and the coverage ratios of every
row, the per-read table's meanQ, the GC statistics and the coverage
fits. One JSON line per seed, then the largest program reading and the
smallest control reading of each number.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from benchmark import gen, harness  # noqa: E402
from benchmark.reference import qc as ref_qc  # noqa: E402


def control_job(entry, state, ref, job):
    """The job's outputs with the control in the program's place: rows
    whose key columns (and, where sampled, all columns) the control
    computed, its per-read table and its QC JSON over the job's rows."""
    cref = entry.reference(state, variant="f32")
    rows = [cref["rows"].get(i) or _row_from_key(key)
            for i, key in enumerate(cref["keys"])]
    out = dict(job, rows=rows)
    if "qc" in job:
        reads = state["reads"]
        table = ref_qc.read_table(reads, dtype=np.float32)
        out["mask"] = [
            ref_qc.mask_row(r, table, i, masked=int(
                ref["mask_full"][i].split("\t")[1]) if i in ref["mask_full"]
                else 0) for i, r in enumerate(reads)]
        out["qc"] = entry.expected_qc(state, ref, job["rows"],
                                      job["control"], dtype=np.float32)
    return out


def _row_from_key(key):
    """A 9-column row with the key's name, length and meanQ (the columns
    that are compared for every row) and zeros elsewhere."""
    name, qlen, meanq = key.split("\t")
    return "\t".join([name, qlen, "0", "0", "0", "0.0", meanq, "0", "0.0"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = harness.cell_of(manifest, args.workload)
    config = harness.load_json(harness.HERE, "configs",
                               cell["config"] + ".json")
    traffic = harness.load_json(harness.HERE, "traffic",
                                cell["traffic"] + ".json")
    entry = harness.load_module("entries", traffic["entry"])
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    worst, least = {}, {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        workdir = tempfile.mkdtemp(prefix="portbench-control-")
        try:
            run = {"config": config, "traffic": traffic, "seed": seed,
                   "device": "cuda", "workdir": workdir,
                   "workers": int(traffic.get("check_workers", 1))}
            run["reads"] = gen.make_reads(seed, config, traffic)
            state = entry.prepare(run)
            t = time.time()
            job = entry.job(state)
            job_s = time.time() - t
            ref = entry.reference(state)
            prog = entry.compare([job], ref, state)
            ctl = entry.compare([control_job(entry, state, ref, job)], ref,
                                state)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"seed": seed, "job_s": job_s, "program": prog,
                          "control": ctl}), flush=True)
        for k, v in prog.items():
            worst[k] = max(worst.get(k, v), v)
        for k, v in ctl.items():
            least[k] = min(least.get(k, v), v)
    print(json.dumps({"program_max": worst, "control_min": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
