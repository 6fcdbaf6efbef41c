"""index.pack_s: host tile packing of the part index (`index_s["pack"]`)
per Gbp of the jobs' target reads."""

from benchmark.arith import job_sum, overlap_stats, per_gbp


def read(run):
    s = job_sum(run["jobs"],
                lambda j: overlap_stats(j).get("index_s", {}).get("pack"))
    return None if s is None else per_gbp(s, run["bases"])
