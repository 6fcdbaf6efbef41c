"""index.build_s: the part index's build and the wait for its host side
(`phase_s` index + part_wait) per Gbp of the jobs' target reads."""

from benchmark.arith import job_sum, overlap_stats, per_gbp


def _build(job):
    ph = overlap_stats(job).get("phase_s")
    if not ph:
        return None
    return ph.get("index", 0.0) + ph.get("part_wait", 0.0)


def read(run):
    s = job_sum(run["jobs"], _build)
    return None if s is None else per_gbp(s, run["bases"])
