"""overlap.step_host_idle_s: seconds in which the card was idle inside
the main thread's host-only step spans (`step.unpack`, `step.commit`,
`step.ranks`: decoding the pull, recording the rows' events, the rank
lookups) per Gbp of the jobs' target reads; needs the traced run's
span_log and device events."""

from benchmark.arith import per_gbp
from benchmark.spans import idle_inside_s

HOST_ONLY = ("step.unpack", "step.commit", "step.ranks")


def read(run):
    s = idle_inside_s(run, HOST_ONLY)
    return None if s is None else per_gbp(s, run["bases"])
