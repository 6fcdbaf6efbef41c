"""pipeline.adapter_s: seconds of the chunk QC's adapter search (its
device DP and its host traceback, `stage_s["adapter"]`) per Gbp of the
jobs' input."""

from benchmark.arith import job_sum, per_gbp


def read(run):
    s = job_sum(run["jobs"], lambda j: j["stats"]["stage_s"].get("adapter"))
    return None if s is None else per_gbp(s, run["bases"])
