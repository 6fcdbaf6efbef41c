"""spike_in.hpc_s: wall seconds of the spike-in run's host homopolymer
compression (`hpc.compress` in stats["spike_in"]: the queries' and the
control part's) per Gbp of the jobs' input."""

from benchmark.arith import per_gbp
from benchmark.spans import span_sum


def read(run):
    s = span_sum(run["jobs"], ("hpc.compress",), sub="spike_in")
    return None if s is None else per_gbp(s, run["bases"])
