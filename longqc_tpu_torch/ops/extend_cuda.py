"""B5: the banded extension kernel (csrc/extend.cu).

`extend_fill` launches the hand-written kernel, the port of
longqc_tpu/ops/extend_pallas (extz_batch_pallas / extz_device), on CUDA
tensors; ops/extend.extz_batch routes CUDA inputs here and CPU inputs
to the plain version, extz_batch_plain. Half band widths up to NARROW_W
take the one-warp body (counted as extz / extd); every wider W, as the
JAX extz_batch takes, the block-per-pair body (extz_wide / extd_wide),
whose band is clamped per pair to min(W, max(qlen, columns)).
"""

import torch

from longqc_tpu_torch.ops import _ext

NARROW_W = 63       # 2W+1 band rows over 32 lanes, up to 4 per lane
SMEM_BYTES = 48 * 1024   # the wide body's band in shared memory up to here
WIDE_BLOCKS = 1024       # blocks of the wide body when its band is in
#                          device memory (one scratch slice each)


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
    ints = 6 * (2 * Wa + 2)
    nblk = B
    scratch = torch.empty(0, dtype=torch.int32, device=q.device)
    if ints * 4 > SMEM_BYTES:
        nblk = min(B, WIDE_BLOCKS)
        scratch = torch.empty(nblk * ints, dtype=torch.int32,
                              device=q.device)
    _ext.LAUNCHES["extd_wide" if dual else "extz_wide"] += 1
    lib.extend_wide_fill(q, ql, t, tl, out, scratch, W, Wa, match, mismatch,
                         *gaps, zdrop, dual, nblk)
    return out
