"""The `overlap_long` entry: the `overlap` entry's job on ultra-long
reads, whose rows hold hundreds of thousands of anchors.

prepare() first asks the port for the largest row it steps on the card
(`engine.device_overlap.ROW_ANCHORS_MAX`) and stops at once where that
is missing or below ROW_MIN: such a port hands every row past its top
anchor rung to the host spec, a Python loop over the anchors, and would
spend an hour on one job. Everything else is entries/overlap.py's.
"""

from benchmark import harness

# the rows this traffic asks of the card: up to ~1M anchors at a 120 Mbp
# part, four times that with room for a part of several hundred Mbp
ROW_MIN = 1 << 22

_ov = harness.load_module("entries", "overlap")
warmup, job, reference, compare = (_ov.warmup, _ov.job, _ov.reference,
                                   _ov.compare)


def row_anchors_max():
    """The port's ROW_ANCHORS_MAX, or None where it has none."""
    from longqc_tpu_torch.engine import device_overlap
    return getattr(device_overlap, "ROW_ANCHORS_MAX", None)


def prepare(run):
    got = row_anchors_max()
    if got is None or got < ROW_MIN:
        raise RuntimeError(
            "overlap_long needs a port that steps rows of %d anchors on the "
            "card (engine.device_overlap.ROW_ANCHORS_MAX); this one has %s"
            % (ROW_MIN, "none" if got is None else got))
    return _ov.prepare(run)
