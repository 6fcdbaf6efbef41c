"""spike_in.step_s: wall seconds of the spike-in run's step spans (in
stats["spike_in"]: count pass, launch with its two device halves and the
per-row host gap tables between them, pull, unpack, commit, retries,
host fixes) per Gbp of the jobs' input."""

from benchmark.arith import per_gbp
from benchmark.spans import span_sum

STEP = ("step.count", "step.launch", "step.pull", "step.unpack",
        "step.commit", "step.retry", "step.host_fix")


def read(run):
    s = span_sum(run["jobs"], STEP, sub="spike_in")
    return None if s is None else per_gbp(s, run["bases"])
