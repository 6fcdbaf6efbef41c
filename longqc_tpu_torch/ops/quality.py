"""Quality-score statistics as batched torch ops (port of
longqc_tpu/ops/quality).

The reference's phred->error table q2p[] (lqutils.c:26-49; the literal
values, which are not exactly round(10^(-q/10), 15), are the behavioral
spec) and its per-read metrics:
  - meanQ   -10*log10(mean error)           (lqutils.c:51-58)
  - nQx     #bases with phred > threshold   (lqutils.c:72-80; note the
            strict '>' comparison)

Batched over padded (N, L) phred tiles with length masking, on the
tiles' device. The per-read phred histogram is counted with one
scatter-add into (N * 127) bins, so no (N, L, 127) one-hot is built;
meanQ's f64 contraction with q2p runs on the host, as in the JAX
package, so its values are bit-identical to the JAX meanQ.
"""

import numpy as np
import torch

N_PHRED = 127

# fmt: off
Q2P = np.array([
    1.000000000000000, 0.794328234724281, 0.630957344480193, 0.501187233627272,
    0.398107170553497, 0.316227766016838, 0.251188643150958, 0.199526231496888,
    0.158489319246111, 0.125892541179417, 0.100000000000000, 0.079432823472428,
    0.063095734448019, 0.050118723362727, 0.039810717055350, 0.031622776601684,
    0.025118864315096, 0.019952623149689, 0.015848931924611, 0.012589254117942,
    0.010000000000000, 0.007943282347243, 0.006309573444802, 0.005011872336273,
    0.003981071705535, 0.003162277660168, 0.002511886431510, 0.001995262314969,
    0.001584893192461, 0.001258925411794, 0.001000000000000, 0.000794328234724,
    0.000630957344480, 0.000501187233627, 0.000398107170554, 0.000316227766017,
    0.000251188643151, 0.000199526231497, 0.000158489319246, 0.000125892541180,
    0.000100000000000, 0.000079432823472, 0.000063095734448, 0.000050118723363,
    0.000039810717055, 0.000031622776602, 0.000025118864315, 0.000019952623150,
    0.000015848931925, 0.000012589254118, 0.000010000000000, 0.000007943282347,
    0.000006309573445, 0.000005011872336, 0.000003981071706, 0.000003162277660,
    0.000002511886432, 0.000001995262315, 0.000001584893193, 0.000001258925412,
    0.000001000000000, 0.000000794328235, 0.000000630957345, 0.000000501187234,
    0.000000398107171, 0.000000316227766, 0.000000251188643, 0.000000199526232,
    0.000000158489319, 0.000000125892541, 0.000000100000000, 0.000000079432824,
    0.000000063095735, 0.000000050118723, 0.000000039810717, 0.000000031622777,
    0.000000025118864, 0.000000019952623, 0.000000015848932, 0.000000012589254,
    0.000000010000000, 0.000000007943282, 0.000000006309574, 0.000000005011872,
    0.000000003981072, 0.000000003162278, 0.000000002511886, 0.000000001995262,
    0.000000001584893, 0.000000001258925, 0.000000001000000, 0.000000000794328,
    0.000000000630957, 0.000000000501187, 0.000000000398107, 0.000000000316228,
    0.000000000251189, 0.000000000199526, 0.000000000158489, 0.000000000125893,
    0.000000000100000, 0.000000000079433, 0.000000000063096, 0.000000000050119,
    0.000000000039811, 0.000000000031623, 0.000000000025119, 0.000000000019953,
    0.000000000015849, 0.000000000012589, 0.000000000010000, 0.000000000007943,
    0.000000000006310, 0.000000000005012, 0.000000000003981, 0.000000000003162,
    0.000000000002512, 0.000000000001995, 0.000000000001585, 0.000000000001259,
    0.000000000001000, 0.000000000000794, 0.000000000000631, 0.000000000000501,
    0.000000000000398, 0.000000000000316, 0.000000000000251,], dtype=np.float64)
# fmt: on


def mean_q_host(qual_str):
    """Host scalar meanQ for oracle tests (sequential f64 sum as in C)."""
    idx = np.frombuffer(qual_str.encode("ascii"), dtype=np.uint8).astype(np.int64) - 33
    # np.add.accumulate is elementwise-sequential: identical f64
    # rounding to the C left-to-right loop, at C speed
    s = float(np.add.accumulate(Q2P[idx])[-1])
    return -10.0 * np.log10(s / len(idx))


def _length_mask(lengths, lmax):
    pos = torch.arange(lmax, dtype=torch.int32, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def qual_hist_batch(quals, lengths):
    """Per-read phred histogram (N, 127) int32 of padded (N, L) phred
    tiles (tensors of one device); phred values are clamped to 0..126."""
    n, lmax = quals.shape
    mask = _length_mask(lengths, lmax)
    q = quals.to(torch.int64).clamp_(0, N_PHRED - 1)
    rows = torch.arange(n, dtype=torch.int64, device=quals.device)
    # bins past the read's end go to one spare bin, dropped below
    idx = torch.where(mask, rows[:, None] * N_PHRED + q, n * N_PHRED)
    hist = torch.zeros(n * N_PHRED + 1, dtype=torch.int32,
                       device=quals.device)
    hist.scatter_add_(0, idx.reshape(-1),
                      torch.ones(idx.numel(), dtype=torch.int32,
                                 device=quals.device))
    return hist[:-1].view(n, N_PHRED)


def mean_q_from_hist(hist, lengths):
    """Host finalization of numpy arrays: meanQ =
    -10*log10(sum(count_q * q2p[q]) / len), in f64."""
    hist = np.asarray(hist, dtype=np.float64)
    s = hist @ Q2P
    mean = s / np.maximum(np.asarray(lengths, dtype=np.float64), 1.0)
    return -10.0 * np.log10(mean)


def mean_q_batch(quals, lengths):
    """Per-read meanQ: histogram on the tiles' device + host f64
    finalization."""
    return mean_q_from_hist(qual_hist_batch(quals, lengths).cpu().numpy(),
                            lengths.cpu().numpy())


def n_qx_batch(quals, lengths, threshold=7):
    """Per-read count (int32) of bases with phred strictly greater than
    threshold: the C code compares raw ascii, (int)qual[i] > threshold +
    33 (lqutils.c:72-80)."""
    mask = _length_mask(lengths, quals.shape[1])
    gt = (quals.to(torch.int32) > threshold) & mask
    return gt.sum(dim=1, dtype=torch.int32)
