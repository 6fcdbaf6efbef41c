"""B5: the banded extension kernel (csrc/extend.cu).

`extend_fill` launches the hand-written kernel, the port of
longqc_tpu/ops/extend_pallas (extz_batch_pallas / extz_device), on CUDA
tensors; ops/extend.extz_batch routes CUDA inputs here and CPU inputs
to the plain version, extz_batch_plain. Half band widths up to NARROW_W
take the one-warp body (counted as extz / extd); every wider W, as the
JAX lax.scan extz_batch takes, the wide body (extz_wide / extd_wide),
which walks each pair's columns in strips of 64 with a boundary column
in device memory, and whose band is clamped per pair to min(W,
max(qlen, columns)).
"""

import torch

from longqc_tpu_torch.ops import _ext

NARROW_W = 63       # W+1 live columns in 64 slots of one warp
WIDE_SCRATCH_BYTES = 1 << 28   # the wide body's boundary columns (one a
#                                pair slot) take at most this many bytes
WIDE_ROW_WARPS = 16  # the wide body's warps (pairs x warps a pair) per
#                      band row, past which more warps a pair cost more
#                      issue slots than their shorter walks save


def wide_warps(B, Wa):
    """Warps a pair takes in the wide body: 1, 2, 4 or 8, doubling while
    the strip (64 columns a warp) stays at most half a column tall (2 Wa +
    1 band rows), so its ramp costs little, and the B pairs' warps stay
    within WIDE_ROW_WARPS a band row: many pairs fill the card at one
    warp each, few long pairs walk their strips with more."""
    rows = 2 * Wa + 1
    G = 1
    while G < 8 and rows >= 256 * G and 2 * G * B <= WIDE_ROW_WARPS * rows:
        G *= 2
    return G


def wide_order(ql, tl, Lt, Wa):
    """The wide body's pair order: the most band cells (columns x column
    height) first, so that the longest pairs do not start last."""
    cells = (tl.clamp(0, Lt).long() * ql.clamp(0, 2 * Wa + 1).long())
    return torch.argsort(cells, descending=True).to(torch.int32)


def extend_fill(query, qlens, target, tlens, *, W, match=2, mismatch=-4,
                gapo=4, gape=2, gapo2=None, gape2=None, zdrop=400):
    """(B, Lq) / (B, Lt) int32 codes and (B,) int32 lengths on one CUDA
    device -> the (8, B) int32 outputs in ops/extend.KEYS order
    (zdropped as 0 / 1). gapo2/gape2 select extd."""
    if W <= 0:
        raise ValueError("extension kernel takes W > 0, got %d" % W)
    ins = [t.contiguous() for t in (query, qlens, target, tlens)]
    _ext.require_cuda(*ins)
    q, ql, t, tl = ins
    B = q.shape[0]
    if q.dim() != 2 or t.dim() != 2 or t.shape[0] != B or \
            tuple(ql.shape) != (B,) or tuple(tl.shape) != (B,):
        raise ValueError("extension takes (B, Lq), (B,), (B, Lt), (B,)")
    dual = gapo2 is not None
    out = torch.empty((8, B), dtype=torch.int32, device=q.device)
    lib = _ext.lib()
    gaps = (gapo, gape, gapo2 if dual else 0, gape2 if dual else 0)
    if W <= NARROW_W:
        _ext.LAUNCHES["extd" if dual else "extz"] += 1
        lib.extend_fill(q, ql, t, tl, out, W, match, mismatch, *gaps, zdrop,
                        dual)
        return out
    if B == 0:
        return out
    # every pair's clamped half band is at most Wa (one host read of the
    # longest query length: lengths may pass the code arrays' width)
    Wa = min(W, max(int(ql.max()), t.shape[1], 0))
    ints = (3 if dual else 2) * (2 * Wa + 1)
    nslot = min(B, max(1, WIDE_SCRATCH_BYTES // (4 * ints)))
    scratch = torch.empty(nslot * ints, dtype=torch.int32, device=q.device)
    order = wide_order(ql, tl, t.shape[1], Wa)
    _ext.LAUNCHES["extd_wide" if dual else "extz_wide"] += 1
    lib.extend_wide_fill(q, ql, t, tl, order, out, scratch, W, Wa, match,
                         mismatch, *gaps, zdrop, dual, nslot,
                         wide_warps(B, Wa))
    return out
