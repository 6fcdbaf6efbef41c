"""Mask-table builder (LqMask equivalent; port of
longqc_tpu/engine/masking).

Produces the reference's `longqc_sdust.txt` 6-column table
(sdust.c:211-217): name, masked_len, len, masked_frac, meanQ, nQ7.
The reference shells out to the sdust binary per chunk (lq_mask.py);
here the screen and the quality histograms run as batched torch ops on
the given device and only screen-flagged reads take the exact host
recursion.
"""

import os
from logging import getLogger

import torch

from longqc_tpu_torch.io.pack import pack_reads, SEQ_NT4_SDUST
from longqc_tpu_torch.ops._ext import require_device
from longqc_tpu_torch.ops.quality import qual_hist_batch, mean_q_from_hist
from longqc_tpu_torch.ops.sdust import sdust_screen_batch, masked_length

logger = getLogger(__name__)


def _len_bucket(n):
    """Row width of a read's batch: the next power of two from 256, so
    padding stays under 2x (and batches hold the JAX package's reads,
    so meanQ's f64 contraction sees the same (N, 127) histograms)."""
    b = 256
    while b < n:
        b *= 2
    return b


def mask_table_rows(reads, batch_size=128, device="cuda"):
    """-> list of 6-column row strings for a chunk of reads."""
    device = require_device(device)
    rows = [None] * len(reads)
    buckets = {}
    for i, r in enumerate(reads):
        buckets.setdefault(_len_bucket(len(r[1])), []).append(i)
    for blen, idxs in sorted(buckets.items()):
        for off in range(0, len(idxs), batch_size):
            sel = idxs[off:off + batch_size]
            chunk = [reads[i] for i in sel]
            batch = pack_reads(chunk, table=SEQ_NT4_SDUST, max_len=blen,
                               pad_to=blen)
            codes = torch.from_numpy(batch.codes).to(device)
            quals = torch.from_numpy(batch.quals).to(device)
            lengths = torch.from_numpy(batch.lengths).to(device)
            flags = sdust_screen_batch(codes, lengths).cpu().numpy()
            hist = qual_hist_batch(quals, lengths).cpu().numpy()
            meanq = mean_q_from_hist(hist, batch.lengths)
            # nQ7: bases with phred strictly above 7 (lqutils.c:72-80)
            nq7 = hist[:, 8:].sum(axis=1)
            for slot, i in enumerate(sel):
                name, seq = reads[i][0], reads[i][1]
                ln = len(seq)
                ml = masked_length(seq) if flags[slot] else 0
                rows[i] = "%s\t%d\t%d\t%.3f\t%.3f\t%d" % (
                    name, ml, ln, ml / ln if ln else 0.0,
                    meanq[slot], int(nq7[slot]))
    return rows


class MaskAccumulator:
    """Streaming mask-table writer across chunks (LqMask-equivalent).
    `device` is passed to every chunk explicitly, so a worker thread
    drives the same device as the caller."""

    def __init__(self, work_dir, suffix="", device="cuda"):
        self.device = require_device(device)
        self.suffix = ("_" + suffix) if suffix else ""
        os.makedirs(work_dir, exist_ok=True)
        self.outf = os.path.join(work_dir,
                                 "longqc_sdust" + self.suffix + ".txt")
        self._fh = open(self.outf, "w")

    def add_chunk(self, reads):
        for row in mask_table_rows(reads, device=self.device):
            self._fh.write(row + "\n")

    def close(self):
        self._fh.close()

    def get_outfile_path(self):
        return self.outf
