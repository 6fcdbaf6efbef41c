"""Minimal BAM reader (no pysam dependency).

Parses BGZF-compressed BAM files (BGZF is standard multi-member gzip,
which Python's gzip module decodes transparently) and yields unaligned
or aligned records' (name, seq, qual). Used for PacBio subread BAM
ingestion (cf. lq_utils.parse_bam_chunk, lq_utils.py:238-261: Sequel
subread BAMs carry no meaningful QV, so qual is '!' per base when
is_sequel=True) and for Sequel platform QC (scraps/subreads parsing).
"""

import gzip
import struct
import sys
from logging import getLogger

logger = getLogger(__name__)

# 4-bit base codes -> IUPAC (SAM spec section 4.2.3)
SEQ_DECODE = "=ACMGRSVTWYHKDBN"
_TWO_BASE = [SEQ_DECODE[(b >> 4) & 0xF] + SEQ_DECODE[b & 0xF]
             for b in range(256)]

# typecode -> (struct fmt, size) for optional-field parsing
_TAG_FMT = {
    ord("c"): ("b", 1), ord("C"): ("B", 1), ord("s"): ("h", 2),
    ord("S"): ("H", 2), ord("i"): ("i", 4), ord("I"): ("I", 4),
    ord("f"): ("f", 4),
}


class BamRecord:
    __slots__ = ("name", "seq", "qual", "flag", "ref_id", "pos", "mapq",
                 "tags_raw", "_tags")

    def __init__(self, name, seq, qual, flag, ref_id, pos, mapq, tags_raw):
        self.name = name
        self.seq = seq
        self.qual = qual  # list of phred ints or None
        self.flag = flag
        self.ref_id = ref_id
        self.pos = pos
        self.mapq = mapq
        self.tags_raw = tags_raw
        self._tags = None

    @property
    def tags(self):
        if self._tags is None:
            self._tags = _parse_tags(self.tags_raw)
        return self._tags

    def get_tag(self, tag):
        return self.tags[tag]

    def has_tag(self, tag):
        return tag in self.tags


def _parse_tags(buf):
    tags = {}
    off = 0
    n = len(buf)
    while off + 3 <= n:
        tag = buf[off:off + 2].decode("ascii")
        tc = buf[off + 2]
        off += 3
        if tc in _TAG_FMT:
            fmt, sz = _TAG_FMT[tc]
            (val,) = struct.unpack_from("<" + fmt, buf, off)
            off += sz
        elif tc in (ord("A"),):
            val = chr(buf[off])
            off += 1
        elif tc in (ord("Z"), ord("H")):
            end = buf.index(b"\x00", off)
            val = buf[off:end].decode("ascii")
            off = end + 1
        elif tc == ord("B"):
            sub = buf[off]
            (cnt,) = struct.unpack_from("<I", buf, off + 1)
            fmt, sz = _TAG_FMT[sub]
            val = list(struct.unpack_from("<%d%s" % (cnt, fmt), buf, off + 5))
            off += 5 + cnt * sz
        else:
            raise ValueError("unknown BAM tag type %r" % chr(tc))
        tags[tag] = val
    return tags


def _decode_seq(packed, l_seq):
    s = "".join(_TWO_BASE[b] for b in packed)
    return s[:l_seq]


class BamReader:
    """Iterate records of a BAM file. check_sq-free (unaligned BAMs OK)."""

    def __init__(self, fn):
        self.fn = fn
        self.fh = gzip.open(fn, "rb")
        magic = self.fh.read(4)
        if magic != b"BAM\x01":
            raise ValueError("%s is not a BAM file" % fn)
        (l_text,) = struct.unpack("<i", self.fh.read(4))
        self.header_text = self.fh.read(l_text).decode("ascii", "replace")
        (n_ref,) = struct.unpack("<i", self.fh.read(4))
        self.references = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self.fh.read(4))
            name = self.fh.read(l_name)[:-1].decode("ascii")
            (l_ref,) = struct.unpack("<i", self.fh.read(4))
            self.references.append((name, l_ref))

    def __iter__(self):
        return self

    def __next__(self):
        hdr = self.fh.read(4)
        if len(hdr) < 4:
            self.fh.close()
            raise StopIteration
        (block_size,) = struct.unpack("<i", hdr)
        data = self.fh.read(block_size)
        (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
         _next_ref, _next_pos, _tlen) = struct.unpack_from("<iiBBHHHiiii", data, 0)
        off = 32
        name = data[off:off + l_read_name - 1].decode("ascii")
        off += l_read_name
        off += n_cigar * 4
        n_packed = (l_seq + 1) // 2
        seq = _decode_seq(data[off:off + n_packed], l_seq)
        off += n_packed
        qual_bytes = data[off:off + l_seq]
        off += l_seq
        if l_seq and qual_bytes and qual_bytes[0] == 0xFF:
            qual = None
        else:
            qual = list(qual_bytes)
        return BamRecord(name, seq, qual, flag, ref_id, pos, mapq, data[off:])

    def close(self):
        self.fh.close()


def parse_bam_chunk(fn, cs, is_sequel=True, is_upper=False):
    """Yield (reads, n_seqs, n_bases) chunks from a BAM file.

    Matches lq_utils.parse_bam_chunk accounting (lq_utils.py:238-261).
    """
    reads = []
    n_seqs = 0
    n_bases = 0
    size = 0
    for rec in BamReader(fn):
        n_seqs += 1
        n_bases += len(rec.seq)
        if is_sequel or rec.qual is None:
            qual_33 = "!" * len(rec.seq)
        else:
            qual_33 = "".join(chr(q + 33) for q in rec.qual)
        seq = rec.seq.upper() if is_upper else rec.seq
        reads.append([rec.name, seq, qual_33])
        size += sys.getsizeof(rec.name) + sys.getsizeof(seq) + sys.getsizeof(qual_33)
        if size >= cs:
            yield (reads, n_seqs, n_bases)
            size = 0
            reads = []
    yield (reads, n_seqs, n_bases)
