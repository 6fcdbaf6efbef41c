"""pipeline.overlap_s: seconds of sampleqc's overlap stage
(`stage_s["overlap"]`) per Gbp of the jobs' input."""

from benchmark.arith import job_sum, per_gbp


def read(run):
    s = job_sum(run["jobs"], lambda j: j["stats"]["stage_s"].get("overlap"))
    return None if s is None else per_gbp(s, run["bases"])
