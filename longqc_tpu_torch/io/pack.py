"""Packed device representation of read batches.

Reads live on device as fixed-shape int8 code tiles (0..3 = ACGT,
4 = ambiguous) plus int32 lengths and uint8 quality (phred, already
de-offset by 33). Fixed shapes keep XLA happy; everything downstream
masks by length.

Two base-code tables exist in the reference and differ on 'U':
sketch.c:8-25 maps U/u -> 3 (T), while sdust.c:26-43 maps U -> 4.
Both are reproduced.
"""

from dataclasses import dataclass

import numpy as np

# sketch.c-style: U counts as T
SEQ_NT4_SKETCH = np.full(256, 4, dtype=np.uint8)
for i, cs in enumerate(["Aa", "Cc", "Gg", "TtUu"]):
    for c in cs:
        SEQ_NT4_SKETCH[ord(c)] = i

# sdust.c-style: U is ambiguous
SEQ_NT4_SDUST = np.full(256, 4, dtype=np.uint8)
for i, cs in enumerate(["Aa", "Cc", "Gg", "Tt"]):
    for c in cs:
        SEQ_NT4_SDUST[ord(c)] = i


def round_up(x, m):
    return ((x + m - 1) // m) * m


@dataclass
class ReadBatch:
    """A padded batch of reads as host numpy arrays, ready for device put."""
    names: list
    codes: np.ndarray    # (N, Lmax) uint8, table-coded; padding = 4
    quals: np.ndarray    # (N, Lmax) uint8, phred (ascii-33, clamped >= 0)
    lengths: np.ndarray  # (N,) int32

    @property
    def n_reads(self):
        return len(self.names)

    @property
    def max_len(self):
        return self.codes.shape[1]


def _encode_into(seq, table, out):
    a = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    out[: len(a)] = table[a]


def pack_reads(reads, table=SEQ_NT4_SKETCH, pad_to=128, max_len=None,
               with_quals=True):
    """Pack a list of [name, seq, qual] into a ReadBatch.

    pad_to:  row length is rounded up to a multiple of this (lane alignment)
    max_len: optional hard cap on row length (longer reads are an error;
             callers bucket by length before packing)
    """
    n = len(reads)
    if n == 0:
        return ReadBatch([], np.zeros((0, pad_to), np.uint8),
                         np.zeros((0, pad_to), np.uint8),
                         np.zeros((0,), np.int32))
    lengths = np.array([len(r[1]) for r in reads], dtype=np.int32)
    lmax = int(lengths.max())
    if max_len is not None:
        assert lmax <= max_len, "read longer than the packing cap"
        lmax = max_len
    lmax = round_up(max(lmax, 1), pad_to)

    codes = np.full((n, lmax), 4, dtype=np.uint8)
    quals = np.zeros((n, lmax), dtype=np.uint8)
    for i, r in enumerate(reads):
        _encode_into(r[1], table, codes[i])
        if with_quals and len(r) > 2 and r[2]:
            q = np.frombuffer(r[2].encode("ascii"), dtype=np.uint8)
            quals[i, : len(q)] = np.maximum(q.astype(np.int16) - 33, 0
                                            ).astype(np.uint8)
    names = [r[0] for r in reads]
    return ReadBatch(names, codes, quals, lengths)
