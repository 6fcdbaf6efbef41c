"""Homopolymer-compressed (HPC) minimizer sketch.

Torch port of longqc_tpu/ops/sketch_hpc.py. HPC mode (-H, the
spike-in-control filter run, longQC.py:255) compresses each run of
identical bases to one entry; the k-mer span is the total original
bases covered by the window's last <= k runs (sketch.c:92-104). The
compression is vectorised numpy on the host; the entries then go
through the tensor sketch (ops/sketch) with per-entry position and
span overrides.
"""

import numpy as np
import torch

from longqc_tpu_torch.io.pack import SEQ_NT4_SKETCH
from longqc_tpu_torch.ops._ext import require_device
from longqc_tpu_torch.ops.sketch import sketch_batch, sketch_to_lists
from longqc_tpu_torch.tracing import span


def hpc_compress(seq, k):
    """-> (codes, positions, spans) numpy arrays for one read.

    codes: per-entry base code (4 = ambiguous, one entry per base)
    positions: original read index of the entry's last base
    spans: windowed sum of the last <= k run lengths since the last
           ambiguous reset (0 for ambiguous entries)
    """
    a = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    codes = SEQ_NT4_SKETCH[a].astype(np.int64)
    n = len(codes)
    if n == 0:
        return (np.zeros(0, np.uint8), np.zeros(0, np.int64),
                np.zeros(0, np.int64))
    # entry boundaries: position i starts an entry if i == 0, its code
    # differs from the previous one, or either is ambiguous (ambiguous
    # bases are single entries; valid runs collapse)
    prev = np.concatenate([[np.int64(-1)], codes[:-1]])
    is_start = (codes != prev) | (codes >= 4) | (prev >= 4)
    is_start[0] = True
    starts = np.nonzero(is_start)[0]
    ends = np.concatenate([starts[1:] - 1, [n - 1]])
    ecodes = codes[starts]
    skips = (ends - starts + 1).astype(np.int64)
    skips[ecodes >= 4] = 0

    # spans: per valid entry, the sum of the last <= k skips since the
    # last ambiguous entry (a segment starts right after it, or at 0)
    m = len(starts)
    cum = np.concatenate([[0], np.cumsum(skips)])
    amb = ecodes >= 4
    ent = np.arange(m)
    seg_start = np.maximum.accumulate(np.where(amb, ent, -1)) + 1
    lo = np.maximum(ent - k + 1, seg_start)
    spans = cum[ent + 1] - cum[lo]
    spans[amb] = 0
    return ecodes.astype(np.uint8), ends.astype(np.int64), spans


def hpc_compress_all(seqs, k):
    """hpc_compress of each sequence, timed as one `hpc.compress` span."""
    with span("hpc.compress"):
        return [hpc_compress(s, k) for s in seqs]


def pack_hpc(comp, L):
    """hpc_compress outputs of B reads -> the (B, L) uint8 codes, (B,)
    int32 lengths and (B, L) int64 positions and spans that sketch_batch
    takes (padding: code 4, position and span 0)."""
    B = len(comp)
    codes = np.full((B, L), 4, np.uint8)
    positions = np.zeros((B, L), np.int64)
    spans = np.zeros((B, L), np.int64)
    lengths = np.zeros(B, np.int32)
    for b, (c, p, s) in enumerate(comp):
        codes[b, :len(c)] = c
        positions[b, :len(c)] = p
        spans[b, :len(c)] = s
        lengths[b] = len(c)
    return codes, lengths, positions, spans


def sketch_reads_hpc(reads, k, w, batch_size=128, device="cuda"):
    """HPC sketch of [name, seq, qual] reads on `device` (the card
    unless the caller asks for the CPU) -> per-read
    (hash, pos, strand, span) arrays (the sketch_to_lists contract)."""
    device = require_device(device)
    comp = hpc_compress_all([r[1] for r in reads], k)
    out = [None] * len(reads)
    buckets = {}
    for i, (c, _p, _s) in enumerate(comp):
        blen = 256
        while blen < max(len(c), 1):
            blen *= 2
        buckets.setdefault(blen, []).append(i)
    for blen, idxs in sorted(buckets.items()):
        for off in range(0, len(idxs), batch_size):
            sel = idxs[off:off + batch_size]
            codes, lengths, positions, spans = (
                torch.from_numpy(a).to(device)
                for a in pack_hpc([comp[i] for i in sel], blen))
            res = sketch_batch(codes, lengths, w=w, k=k,
                               positions=positions, spans=spans)
            for slot, lst in enumerate(sketch_to_lists(res, packed=True)):
                out[sel[slot]] = lst
    return out
