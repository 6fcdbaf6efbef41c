"""B2: the chain-DP score fill kernel (csrc/chain.cu).

`chain_dp_fill` launches the hand-written kernel on CUDA tensors (the
port of longqc_tpu/ops/chain_pallas.chain_dp_batch_pallas) and runs the
plain version ops/chain.chain_dp_batch on CPU tensors; both have the
same contract (see there). Differences from the TPU kernel's contract:
the layout is (Q, A) row-major; every anchor scans its whole admissible
window, so there is no ring depth J, no truncation or max_skip
disagreement flag, no carry and no chunk offset; and the gap cost comes
from f64-exact tables (one per row, (Q, bw+1), or one for every row,
(1, bw+1)) instead of per-row fixed-point limbs, so there is no per-row
"no exact multiplier" flag and bw is bounded only by the shared memory
that holds the table (MAX_BW).

The kernel walks each row in pieces of whole (strand, target) segments,
one warp a piece (ops/chain.piece_starts says where they start), with
`pieces_per_row` pieces a row. Inside `count_pieces()` the calls on the
card also sum the kernel's counters on the device (PieceCounts).
"""

import contextlib
import functools
import threading

import torch

from longqc_tpu_torch import tracing
from longqc_tpu_torch.ops import _ext
from longqc_tpu_torch.ops.chain import chain_dp_batch

# the table must fit one block's 232448 bytes of shared memory
MAX_BW = 232448 // 4 - 1
# warps a block (LQ_PIECE_WARPS in csrc/chain.cu), each a piece of the
# block's row
PIECE_WARPS = 4
# warps a call aims to have in flight, per SM
WARPS_PER_SM = 32

_sink = threading.local()


def pieces_per_row(Q, n_sm):
    """B2's pieces a row for a call of Q rows on a card of n_sm SMs:
    at least WARPS_PER_SM warps an SM over the call, in whole blocks of
    PIECE_WARPS."""
    blocks = -(-WARPS_PER_SM * n_sm // (max(Q, 1) * PIECE_WARPS))
    return PIECE_WARPS * blocks


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


class PieceCounts:
    """The B2 kernel's counters of the calls made while count_pieces()
    is open on this thread, summed on each card (`sums`: device -> int64
    [pieces, longest row, longest piece] summed over the calls). Nothing
    is pulled until `stage` and `record`."""

    NAMES = ("chain.pieces", "chain.row_span", "chain.piece_span")

    def __init__(self):
        self.sums = {}
        self._host = None

    def add(self, dev, call):
        acc = self.sums.get(dev)
        if acc is None:
            self.sums[dev] = call.to(torch.int64)
        else:
            acc += call

    def stage(self):
        """Start the sums' copies to the host without waiting for them:
        a pull made afterwards on each of their devices completes
        them."""
        self._host = [t.to("cpu", non_blocking=True)
                      for t in self.sums.values()]

    def record(self):
        """Add the staged sums (staged now if they were not) to the
        run's counters (tracing.count)."""
        if self._host is None:
            self.stage()
        for t in self._host:
            for name, n in zip(self.NAMES, t.tolist()):
                tracing.count(name, n)
        self._host = None


@contextlib.contextmanager
def count_pieces():
    """Sum the counters of the B2 calls this thread makes on the card
    inside the block into the yielded PieceCounts."""
    prev = getattr(_sink, "counts", None)
    _sink.counts = PieceCounts()
    try:
        yield _sink.counts
    finally:
        _sink.counts = prev


def chain_dp_fill(ax_hi, ax_lo, aq, aspan, n_anchors, pen_tab, *,
                  max_dist=10000, bw=500, max_skip=25):
    """Batched chain-DP fill -> (f, p, v)."""
    Q, A = ax_hi.shape
    if bw > MAX_BW or pen_tab.dim() != 2 or \
            pen_tab.shape[0] not in (1, Q) or pen_tab.shape[1] != bw + 1:
        raise ValueError("penalty tables must be (Q or 1, bw+1) with "
                         "bw <= %d" % MAX_BW)
    if ax_hi.device.type == "cpu":
        return chain_dp_batch(ax_hi, ax_lo, aq, aspan, n_anchors, pen_tab,
                              max_dist=max_dist, bw=bw, max_skip=max_skip)
    ins = [t.contiguous() for t in (ax_hi, ax_lo, aq, aspan, n_anchors,
                                    pen_tab)]
    _ext.require_cuda(*ins)
    dev = ax_hi.device
    # f, p, v and the max_skip mark scratch (the reference's t[])
    f, p, v, marks = (torch.empty((Q, A), dtype=torch.int32, device=dev)
                      for _ in range(4))
    cnt = torch.zeros(3, dtype=torch.int32, device=dev)
    P = pieces_per_row(Q, _sm_count(dev.index))
    lib = _ext.lib()
    _ext.LAUNCHES["chain"] += 1
    lib.chain_fill(*ins, marks, f, p, v, cnt, P, bw, max_dist, max_skip)
    sink = getattr(_sink, "counts", None)
    if sink is not None:
        sink.add(dev, cnt)
    return f, p, v
