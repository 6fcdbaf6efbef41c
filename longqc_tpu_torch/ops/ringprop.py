"""B3 peak pass and B4 min-rank pass over the chain-DP parent forest.

For each (Q, A) row-major int32 row and any window J from 1 to A:

  * peak (forward):   peak[i] = peak[p[i]] when v[i] > f[i] (the walk
    `while f[j] < v[j]: j = p[j]` of chain.c:96-99), p[i] >= 0 and
    1 <= i - p[i] <= J; -1 when the walk applies but p[i] >= i; else i.
  * min-rank (backward): r[i] = min(own_rank[i], min over j in (i, i+J]
    with p[j] == i of r[j]) — ops/chainsel's closed form of the greedy
    backtrack (INF32 = on no candidate chain's path).

A parent outside [i-J, i) reads as the TPU kernels' empty ring slot:
-1 (p >= i) or i (p < i - J) for peak, no edge for min-rank. The chain
fill links each anchor to a parent at any distance back, so the engine
calls both passes with J = A.

`peak_pass` / `minrank_pass` launch csrc/ringprop.cu on CUDA tensors
(ports of longqc_tpu/ops/ringprop.peak_pass / minrank_pass: one block
per row, the row walked in chunks staged in shared memory, each chunk
resolved by pointer jumping / doubling rounds; the source note says
how) and run the plain versions on CPU tensors. Each launch counts in
`_ext.LAUNCHES` and, by (name, Q, A), in `_ext.LAUNCH_SHAPES`.
"""

import torch

from longqc_tpu_torch.ops import _ext

INF32 = 0x7FFFFFFF
# B4 keeps a pending bit per anchor of the row (csrc/ringprop.cu): in
# shared memory for rows of up to SMEM_MARK_A anchors, past it in a
# (Q, ceil(A / 32)) word array in device memory
SMEM_MARK_A = 1 << 20


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
    _ext.LAUNCH_SHAPES["peak", out.shape[0], out.shape[1]] += 1
    lib.peak_pass(*ins, out, J)
    return out


def minrank_pass(p, own_rank, *, J=64):
    """(Q, A) int32 p/own_rank -> (Q, A) int32 min-rank."""
    if p.device.type == "cpu":
        return minrank_pass_plain(p, own_rank, J=J)
    ins = [t.contiguous() for t in (p, own_rank)]
    _ext.require_cuda(*ins)
    _same_shape(*ins)
    Q, A = ins[0].shape
    out = torch.empty_like(ins[0])
    # the kernel clears the mark words itself
    mark = torch.empty((Q, (A + 31) // 32) if A > SMEM_MARK_A else (0,),
                       dtype=torch.int32, device=out.device)
    lib = _ext.lib()
    _ext.LAUNCHES["minrank"] += 1
    _ext.LAUNCH_SHAPES["minrank", Q, A] += 1
    lib.minrank_pass(*ins, out, mark, J)
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
