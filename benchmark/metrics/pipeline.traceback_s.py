"""pipeline.traceback_s: wall seconds of the adapter search's host
traceback (`adapter.align`, one span a candidate: hw_align_host and the
straddle hw_align_optrange) per Gbp of the jobs' input."""

from benchmark.arith import per_gbp
from benchmark.spans import span_sum


def read(run):
    s = span_sum(run["jobs"], ("adapter.align",))
    return None if s is None else per_gbp(s, run["bases"])
