"""The `sampleqc` entry: what `sampleqc -x <preset> --no-report` runs.

A job is one call of the port's run_sampleqc over the cell's FASTQ
(written once a run), with the preset's settings, on the card, into an
output folder of its own that is read and deleted after the job: the
QC JSON, the per-read table (longqc_sdust.txt), the coverage rows and,
for PacBio, the spike-in rows. The report stage (figures, HTML) is not
run: the card machine has no matplotlib.
"""

import os
import shutil

import numpy as np

from benchmark import check, gen
from benchmark.reference import overlap as ref_ov
from benchmark.reference import qc as ref_qc


def prepare(run):
    reads = run["reads"]
    path = os.path.join(run["workdir"], "input.fastq")
    gen.write_fastq(path, reads)
    warm = os.path.join(run["workdir"], "warmup.fastq")
    gen.write_fastq(warm, gen.warmup_reads(run["seed"], run["config"],
                                           run["traffic"]))
    return {"run": run, "reads": reads, "path": path, "warm": warm,
            "bases": sum(len(r[1]) for r in reads), "n": 0}


def _job(state, path):
    from longqc_tpu_torch.engine.pipeline import run_sampleqc
    run = state["run"]
    s = run["config"]["settings"]
    state["n"] += 1
    out = os.path.join(run["workdir"], "job%04d" % state["n"])
    stats = {}
    try:
        qc = run_sampleqc(path, out, run["config"]["preset"],
                          nsample=int(s["n_sample"]),
                          index_size=s["index_size"], report=False,
                          device=run["device"], stats=stats)
        mm2 = os.path.join(out, "analysis", "minimap2")
        rows = _lines(os.path.join(mm2, "coverage_out.txt"))
        ctl = os.path.join(mm2, "spiked_in_control.txt")
        control = _lines(ctl) if os.path.exists(ctl) else None
        mask = _lines(os.path.join(out, "analysis", "longqc_sdust.txt"))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return {"qc": qc, "rows": rows, "control": control, "mask": mask,
            "stats": stats, "queries": len(rows)}


def _lines(path):
    with open(path) as f:
        return [ln for ln in f.read().split("\n") if ln]


def warmup(state):
    _job(state, state["warm"])


def job(state):
    out = _job(state, state["path"])
    out["bases"] = state["bases"]
    return out


def reference(state, variant=None):
    """The reference's per-read table, subsample, rows of a sample of
    queries and adapter tallies (the coverage fits follow each job's own
    rows: see compare)."""
    run = state["run"]
    cfg, traffic = run["config"], run["traffic"]
    reads = state["reads"]
    table = ref_qc.read_table(reads)
    names = [r[0] for r in reads]
    by_name = {r[0]: r for r in reads}
    sample = [by_name[n] for n in
              ref_qc.subsample_names(reads, int(cfg["settings"]["n_sample"]))]
    keys = [ref_ov.row_key(q[0], len(q[1]), q[2], variant) for q in sample]
    rng = gen.make_rng([int(run["seed"]), 2])
    n = min(int(traffic["check_rows"]), len(sample))
    picks = sorted(int(i) for i in rng.permutation(len(sample))[:n])
    rows, _ = ref_ov.rows_for(reads, sample, picks, cfg["overlap"],
                              device=run["device"], workers=run["workers"],
                              variant=variant)
    nm = min(int(traffic["check_mask_rows"]), len(reads))
    mpicks = sorted(int(i) for i in rng.permutation(len(reads))[:nm])
    mask_full = {i: ref_qc.mask_row(reads[i], table, i) for i in mpicks}
    return {"keys": keys, "rows": rows, "table": table,
            "mask_keys": [check.mask_key(table, names, i)
                          for i in range(len(reads))],
            "mask_full": mask_full,
            "adapters": ref_qc.adapter_stats(reads, cfg["settings"]["adp5"],
                                             cfg["settings"]["adp3"])}


def expected_qc(state, ref, rows, control, dtype=np.float64):
    s = state["run"]["config"]["settings"]
    return ref_qc.qc_json(state["reads"], ref["table"], rows, control,
                          s["adp5"], s["adp3"], dtype=dtype,
                          adapters=ref["adapters"])


def compare(jobs, ref, state):
    out = {"rows_keys_bad": 0, "rows_bad": 0, "mask_bad": 0,
           "qc_exact_bad": 0, "qc_rel_err": 0.0}
    for j in jobs:
        out["rows_keys_bad"] += check.rows_keys_bad(j["rows"], ref["keys"])
        out["rows_bad"] += check.rows_bad(j["rows"], ref["rows"])
        out["mask_bad"] += check.mask_bad(j["mask"], ref["mask_keys"],
                                          ref["mask_full"])
        exact, rel = check.qc_compare(
            j["qc"], expected_qc(state, ref, j["rows"], j["control"]))
        out["qc_exact_bad"] += exact
        out["qc_rel_err"] = max(out["qc_rel_err"], rel)
    return out
