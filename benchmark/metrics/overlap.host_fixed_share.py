"""overlap.host_fixed_share: rows the device engine handed to the host
spec (`host_fixed_rows`), as a share of queries times index parts: the
work done twice."""

from benchmark.arith import job_sum, overlap_stats


def read(run):
    fixed = job_sum(run["jobs"],
                    lambda j: overlap_stats(j).get("host_fixed_rows"))
    slots = job_sum(run["jobs"], lambda j: j["queries"] * max(
        len(overlap_stats(j).get("part_ranges", [])), 1))
    if fixed is None or not slots:
        return None
    return 100.0 * fixed / slots
