"""index.wait_on_pack_s: the main thread's wait for the next part
(`part.wait`) that the side thread's tile packing (`part.pack`) covers,
per Gbp of the jobs' target reads; the rest of the wait is reading the
part (`part.read`). Needs the traced run's span_log."""

from benchmark.arith import per_gbp
from benchmark.spans import intersect, length_s, log_intervals


def read(run):
    wait = log_intervals(run["jobs"], ("part.wait",), "main")
    pack = log_intervals(run["jobs"], ("part.pack",), "part")
    if wait is None:
        return None
    return per_gbp(length_s(intersect(wait, pack)), run["bases"])
