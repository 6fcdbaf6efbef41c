"""B3 peak pass and B4 min-rank pass over the chain-DP parent forest.

The chain fill links each anchor to a parent at most J anchors back on
unflagged rows (1 <= i - p[i] <= J), which bounds the two
pointer-chasing passes of chain extraction:

  * peak (forward):   peak[i] = peak[p[i]] when v[i] > f[i] (the walk
    `while f[j] < v[j]: j = p[j]` of chain.c:96-99), else i.
  * min-rank (backward): r[i] = min(own_rank[i], min over j in (i, i+J]
    with p[j] == i of r[j]) — ops/chainsel's closed form of the greedy
    backtrack (INF32 = on no candidate chain's path).

`peak_pass` / `minrank_pass` launch csrc/ringprop.cu on CUDA tensors
(ports of longqc_tpu/ops/ringprop.peak_pass / minrank_pass) and run the
plain versions on CPU tensors. Layout is (Q, A) row-major int32. A
parent outside the J window reads as the TPU kernels' empty ring slot:
rows with such parents are flagged by the chain fill and recomputed
by the host spec.
"""

import torch

from longqc_tpu_torch.ops import _ext

INF32 = 0x7FFFFFFF


def _same_shape(first, *rest):
    if first.dim() != 2 or any(t.shape != first.shape for t in rest):
        raise ValueError("ring passes take (Q, A) tensors of one shape")


def peak_pass(f, v, p, *, J=64):
    """(Q, A) int32 f/v/p -> (Q, A) int32 peak (absolute indices)."""
    if f.device.type == "cpu":
        return peak_pass_plain(f, v, p, J=J)
    ins = [t.contiguous() for t in (f, v, p)]
    _ext.require_cuda(*ins)
    _same_shape(*ins)
    out = torch.empty_like(ins[0])
    lib = _ext.lib()
    _ext.LAUNCHES["peak"] += 1
    lib.peak_pass(*ins, out, J)
    return out


def minrank_pass(p, own_rank, *, J=64):
    """(Q, A) int32 p/own_rank -> (Q, A) int32 min-rank."""
    if p.device.type == "cpu":
        return minrank_pass_plain(p, own_rank, J=J)
    ins = [t.contiguous() for t in (p, own_rank)]
    _ext.require_cuda(*ins)
    _same_shape(*ins)
    out = torch.empty_like(ins[0])
    lib = _ext.lib()
    _ext.LAUNCHES["minrank"] += 1
    lib.minrank_pass(*ins, out, J)
    return out


def peak_pass_plain(f, v, p, *, J=64):
    """Plain version of peak_pass: the forward loop over anchors,
    vectorised over rows."""
    Q, A = f.shape
    rows = torch.arange(Q, device=f.device)
    peak = torch.zeros((Q, A), dtype=torch.int32, device=f.device)
    for i in range(A):
        pi = p[:, i]
        tgt = i - pi
        walk = (v[:, i] > f[:, i]) & (pi >= 0) & (tgt <= J)
        sel = torch.where(tgt >= 1, peak[rows, pi.clamp(0, A - 1)], -1)
        peak[:, i] = torch.where(walk, sel, i)
    return peak


def minrank_pass_plain(p, own_rank, *, J=64):
    """Plain version of minrank_pass: the backward loop over anchors,
    each finished r[j] folded into its parent's running minimum."""
    Q, A = p.shape
    rows = torch.arange(Q, device=p.device)
    r = torch.full((Q, A), INF32, dtype=torch.int32, device=p.device)
    for i in range(A - 1, -1, -1):
        ri = torch.minimum(own_rank[:, i], r[:, i])
        r[:, i] = ri
        pi = p[:, i]
        d = i - pi
        ok = (pi >= 0) & (d >= 1) & (d <= J)
        tgt = torch.where(ok, pi, i)
        r[rows, tgt] = torch.where(ok, torch.minimum(r[rows, tgt], ri),
                                   r[rows, tgt])
    return r
