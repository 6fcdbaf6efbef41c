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
"""

import torch

from longqc_tpu_torch.ops import _ext
from longqc_tpu_torch.ops.chain import chain_dp_batch

# the table must fit one block's 232448 bytes of shared memory
MAX_BW = 232448 // 4 - 1


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
    lib = _ext.lib()
    _ext.LAUNCHES["chain"] += 1
    lib.chain_fill(*ins, marks, f, p, v, bw, max_dist, max_skip)
    return f, p, v
