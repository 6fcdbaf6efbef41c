"""overlap.wide_pad_share: the padding of the wide rungs' steps, 100 x
(1 - count-pass anchors of their rows / their lanes x rung), from the
counters `step.wide_anchors` and `step.wide_slots` summed over the
jobs; nothing where no job ran one."""

from benchmark.arith import job_sum


def _counter(name):
    def get(job):
        return (((job.get("stats") or {}).get("spans") or {})
                .get("counters") or {}).get(name)
    return get


def read(run):
    slots = job_sum(run["jobs"], _counter("step.wide_slots"))
    if not slots:
        return None
    anchors = job_sum(run["jobs"], _counter("step.wide_anchors")) or 0
    return 100.0 * (1.0 - anchors / slots)
