"""B5: the banded extension kernel (csrc/extend.cu).

`extend_fill` launches the hand-written kernel, the port of
longqc_tpu/ops/extend_pallas (extz_batch_pallas / extz_device), on CUDA
tensors; ops/extend.extz_batch routes CUDA inputs here and CPU inputs
to the plain version, extz_batch_plain. The kernel takes half band
widths up to MAX_W, the TPU kernel's limit (a wider band raises; it is
never routed to the plain version).
"""

import torch

from longqc_tpu_torch.ops import _ext

MAX_W = 63          # 2W+1 band rows over 32 lanes, up to 4 per lane


def extend_fill(query, qlens, target, tlens, *, W, match=2, mismatch=-4,
                gapo=4, gape=2, gapo2=None, gape2=None, zdrop=400):
    """(B, Lq) / (B, Lt) int32 codes and (B,) int32 lengths on one CUDA
    device -> the (8, B) int32 outputs in ops/extend.KEYS order
    (zdropped as 0 / 1). gapo2/gape2 select extd."""
    if not 0 < W <= MAX_W:
        raise ValueError("extension kernel takes 0 < W <= %d, got %d"
                         % (MAX_W, W))
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
    _ext.LAUNCHES["extd" if dual else "extz"] += 1
    lib.extend_fill(q, ql, t, tl, out, W, match, mismatch, gapo, gape,
                    gapo2 if dual else 0, gape2 if dual else 0, zdrop, dual)
    return out
