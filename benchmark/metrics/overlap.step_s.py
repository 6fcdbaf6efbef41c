"""overlap.step_s: the device engine's count pass, step and pull
(`phase_s` count + step + pull, each ending in a pull to the host) per
Gbp of the jobs' target reads."""

from benchmark.arith import job_sum, overlap_stats, per_gbp


def _step(job):
    ph = overlap_stats(job).get("phase_s")
    if not ph:
        return None
    return sum(ph.get(k, 0.0) for k in ("count", "step", "pull"))


def read(run):
    s = job_sum(run["jobs"], _step)
    return None if s is None else per_gbp(s, run["bases"])
