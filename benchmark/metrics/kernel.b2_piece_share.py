"""kernel.b2_piece_share: B2's longest piece against its longest row,
100 x chain.piece_span / chain.row_span, the counters the B2 kernel
keeps on the card (csrc/chain.cu): over the jobs' B2 calls, the sum of
each call's longest piece (a run of whole (strand, target) segments,
one warp's walk) and of its longest row, in anchors. A call lasts about
as long as its longest piece; before the rows were split, as long as
its longest row (100 %). Nothing where no job has the counters."""

from benchmark.arith import job_sum


def _counter(name):
    def get(job):
        return (((job.get("stats") or {}).get("spans") or {})
                .get("counters") or {}).get(name)
    return get


def read(run):
    rows = job_sum(run["jobs"], _counter("chain.row_span"))
    if not rows:
        return None
    pieces = job_sum(run["jobs"], _counter("chain.piece_span")) or 0
    return 100.0 * pieces / rows
