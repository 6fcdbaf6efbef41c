"""A part tile's words (the multi-read tiles of engine/device_index) from
its reads' bytes and its layout.

`pack_words` launches the hand-written kernel csrc/pack.cu on CUDA
tensors and runs its plain twin, `pack_words_plain` (numpy), on CPU
tensors. Both give the four word arrays B1 reads (ops/sketch_cuda):
codes2 (R, W // 16), 2-bit codes 16 columns a word; nmask, startmask
and endmask (R, W // 32), one bit a column (ambiguous or padding,
segment start, read end). The kernel replaces no TPU kernel: the JAX
package packs its tiles on the host (longqc_tpu/engine/device_index,
_TileBuilder._pack), and the twin is that numpy body, run from the
layout record:

  raw      (n_bytes,) uint8: the tile's reads' ASCII bytes, in tile order
  row_off  (R + 1,) int32: row r's reads are segs[row_off[r]:row_off[r + 1]]
  segs     (n_reads, 4) int32, one read a row: its segment's first
           column (separators belong to the segment of the read they
           precede), its first base's column, its length, the offset of
           its first byte in raw; columns are a row's own
"""

import numpy as np
import torch

from longqc_tpu_torch.io.pack import SEQ_NT4_SKETCH
from longqc_tpu_torch.ops import _ext

# single-pass encode tables: ASCII byte -> 2-bit code / ambiguity
_CODE_OF = np.where(SEQ_NT4_SKETCH < 4, SEQ_NT4_SKETCH, 0).astype(np.uint8)
_AMB_OF = SEQ_NT4_SKETCH >= 4


def packbits32(arr):
    """Bit/2-bit packing into uint32 words, little-endian in the word.
    Boolean arrays pack 32/word; uint8 code arrays (0..3) 16/word."""
    if arr.dtype == np.uint8:
        R, W = arr.shape
        a = arr.reshape(R, W // 16, 16).astype(np.uint32)
        shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
        return (a << shifts).sum(axis=2, dtype=np.uint32)
    R, W = arr.shape
    a = arr.reshape(R, W // 32, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)[None, None, :]
    return (a << shifts).sum(axis=2, dtype=np.uint32)


def pack_words_plain(raw, row_off, segs, R, W):
    """The plain twin: (codes2, nmask, startmask, endmask) uint32 numpy
    words of the layout record (numpy arrays)."""
    rows = np.repeat(np.arange(R, dtype=np.int64), np.diff(row_off))
    seg, base, rlen, boff = (segs[:, i].astype(np.int64) for i in range(4))
    first = rows * W + base          # flat column of each read's first base
    # ragged arange: each base's offset within its read
    ends = np.cumsum(rlen)
    off = np.arange(int(ends[-1]) if len(ends) else 0, dtype=np.int64)
    off -= np.repeat(ends - rlen, rlen)
    b = raw[np.repeat(boff, rlen) + off]
    tgt = np.repeat(first, rlen) + off
    codes = np.zeros(R * W, np.uint8)
    amb = np.ones(R * W, bool)          # separators and padding too
    codes[tgt] = _CODE_OF[b]
    amb[tgt] = _AMB_OF[b]
    startb = np.zeros(R * W, bool)
    startb[rows * W + seg] = True
    endb = np.zeros(R * W, bool)
    # a read of no bases ends at the column before its first (index -1,
    # for the first read of row 0: the tile's last column)
    endb[first + rlen - 1] = True
    return tuple(packbits32(a.reshape(R, W))
                 for a in (codes, amb, startb, endb))


def _check(raw, row_off, segs, R, W):
    if W % 32 or W < 32 or R < 1:
        raise ValueError("pack_words needs R >= 1 and W % 32 == 0 "
                         "(R=%d W=%d)" % (R, W))
    if raw.dtype != torch.uint8 or raw.dim() != 1:
        raise TypeError("raw must be a 1-D uint8 tensor")
    if tuple(row_off.shape) != (R + 1,) or segs.dim() != 2 \
            or segs.shape[1] != 4:
        raise ValueError("row_off must be (R + 1,) and segs (n, 4); got "
                         "%s and %s" % (tuple(row_off.shape),
                                        tuple(segs.shape)))


def pack_words(raw, row_off, segs, *, R, W):
    """A tile's (codes2, nmask, startmask, endmask), int32 tensors holding
    the uint32 words, on the device of the layout tensors (raw uint8,
    row_off and segs int32; a row holds at most READS_PER_ROW reads).
    CUDA tensors launch csrc/pack.cu (counted under pack_tile in
    ops/_ext.LAUNCHES), CPU tensors run pack_words_plain."""
    _check(raw, row_off, segs, R, W)
    if raw.device.type == "cpu":
        return tuple(torch.from_numpy(a.view(np.int32)) for a in
                     pack_words_plain(raw.numpy(), row_off.numpy(),
                                      segs.numpy(), R, W))
    row_off, segs = row_off.contiguous(), segs.contiguous()
    _ext.require_cuda(row_off, segs)
    if raw.device != row_off.device or not raw.is_contiguous():
        raise ValueError("raw must be contiguous, on the layout's device")
    dev = raw.device
    codes2 = torch.empty((R, W // 16), dtype=torch.int32, device=dev)
    nmask, smask, emask = (torch.empty((R, W // 32), dtype=torch.int32,
                                       device=dev) for _ in range(3))
    _ext.LAUNCHES["pack_tile"] += 1
    _ext.lib().pack_tile(raw, row_off, segs, codes2, nmask, smask, emask, W)
    return codes2, nmask, smask, emask
