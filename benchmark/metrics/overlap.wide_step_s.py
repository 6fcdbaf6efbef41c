"""overlap.wide_step_s: wall seconds of the device engine's sub-batch
steps at the wide rungs (span `step.wide`: launch, pull, unpack and
commit of rows past the top anchor rung) per Gbp of the jobs' target
reads; nothing where no job ran one."""

from benchmark.arith import per_gbp
from benchmark.spans import span_sum


def read(run):
    s = span_sum(run["jobs"], ("step.wide",))
    return None if s is None else per_gbp(s, run["bases"])
