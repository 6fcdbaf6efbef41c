"""Host-side sequence file I/O.

Format sniffing and chunked streaming readers for FASTA/FASTQ(.gz),
BAM and multi-FAST5, yielding `(reads, n_seqs, n_bases)` tuples where
`reads` is a list of `[name, seq, qual]` (phred+33 string; reads with no
quality get '!' per base).

Behavioral contract follows lq_utils.py:55-305 of the reference:
format codes, chunk-size accounting via `sys.getsizeof` of the three
strings (chunk boundaries feed the per-chunk seeded reservoir sampler,
so the accounting must match exactly), and cumulative n_seqs/n_bases.

No pysam dependency: FASTA/FASTQ parsing is done natively (the port's
C++ reader, csrc/fastx_native.cpp, built by io/native.py) and BAM via
io/bam.py.
"""

import gzip
import os
import sys
import time
from logging import getLogger

logger = getLogger(__name__)

FORMAT_BAM = 0
FORMAT_SAM = 1
FORMAT_FASTQ = 2
FORMAT_FASTA = 3
FORMAT_FAST5 = 4
FORMAT_UNKNOWN = -1


def _open_maybe_gzip(fn, mode="rt"):
    with open(fn, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(fn, mode)
    return open(fn, mode)


def guess_format(fn):
    """Sniff file format -> code {0:BAM,1:SAM,2:FASTQ,3:FASTA,4:FAST5,-1:?}.

    Mirrors lq_utils.guess_format (lq_utils.py:89-184): directories are
    scanned for .fast5 files; magic bytes decide BAM/gzip; text content
    decides SAM vs FASTQ vs FASTA.
    """
    if os.path.isdir(fn):
        for f in os.listdir(fn):
            if f.endswith(".fast5"):
                from longqc_tpu_torch.io import fast5 as f5mod
                if not f5mod.is_multi_fast5(os.path.join(fn, f)):
                    logger.error("single-read fast5 is not supported for sampleqc.")
                    return FORMAT_UNKNOWN
                return FORMAT_FAST5
        logger.error("no fast5 found in directory %s" % fn)
        return FORMAT_UNKNOWN

    with open(fn, "rb") as fh:
        magic = fh.read(4)

    if magic[:4] == b"BAM\x01":
        return FORMAT_BAM
    if magic[:2] == b"\x1f\x8b":
        with gzip.open(fn, "rb") as f:
            head = f.read(4)
        if b"BAM" in head:
            return FORMAT_BAM
        return _guess_sam_fastx(fn, isgzip=True)
    return _guess_sam_fastx(fn, isgzip=False)


def _guess_sam_fastx(fn, isgzip=False):
    """Distinguish SAM / FASTQ / FASTA by line structure
    (cf. lq_utils.py:137-184)."""
    fh = gzip.open(fn, "rt") if isgzip else open(fn, "r")
    at_line_cnt = 0
    try:
        for line in fh:
            if not line:
                continue
            if line[0] == "@":
                at_line_cnt += 1
                continue
            elif at_line_cnt > 0:
                if at_line_cnt > 1:
                    return FORMAT_SAM
                if len(line.split("\t")) == 11:
                    return FORMAT_SAM
                return FORMAT_FASTQ
            elif line[0] == ">" and at_line_cnt == 0:
                return FORMAT_FASTA
            else:
                if len(line.split("\t")) == 11:
                    return FORMAT_SAM
                at_line_cnt = 0
                continue
    finally:
        fh.close()
    return FORMAT_UNKNOWN


def iter_fastx(fn):
    """Yield (name, seq, qual_or_None) records from FASTA/FASTQ(.gz).

    Name is the first whitespace-delimited token (kseq semantics).
    Multi-line FASTA is supported; FASTQ is strict 4-line (universal for
    long-read data). Uses the native C++ reader (io/native.py), or the
    pure-Python lexer below when it could not be built (reader_name()
    says which, and io/native.BUILD why).
    """
    from longqc_tpu_torch.io import native as _native
    if _native.available():
        yield from _native.iter_fastx_native(fn)
        return
    yield from _iter_fastx_py(fn)


def reader_name():
    """The reader iter_fastx uses: "native" or "python"."""
    from longqc_tpu_torch.io import native as _native
    return "native" if _native.available() else "python"


def iter_fastx_timed(fn, clock, key):
    """iter_fastx(fn), adding the seconds spent inside the reader to
    clock[key]."""
    clock.setdefault(key, 0.0)
    it = iter_fastx(fn)
    while True:
        t0 = time.perf_counter()
        rec = next(it, None)
        clock[key] += time.perf_counter() - t0
        if rec is None:
            return
        yield rec


def _iter_fastx_py(fn):
    fh = _open_maybe_gzip(fn, "rt")
    try:
        line = fh.readline()
        while line and not line.strip():
            line = fh.readline()
        if not line:
            return
        if line[0] == ">":
            name = line[1:].split()[0] if line[1:].strip() else ""
            parts = []
            for line in fh:
                if line.startswith(">"):
                    yield name, "".join(parts), None
                    name = line[1:].split()[0] if line[1:].strip() else ""
                    parts = []
                else:
                    parts.append(line.strip())
            yield name, "".join(parts), None
        elif line[0] == "@":
            while True:
                name = line[1:].split()[0] if line[1:].strip() else ""
                seq = fh.readline().strip()
                plus = fh.readline()
                if not plus:
                    break
                qual = fh.readline().strip()
                yield name, seq, qual
                line = fh.readline()
                if not line:
                    break
        else:
            raise ValueError("unrecognized fastx leading character %r" % line[0])
    finally:
        fh.close()


def parse_fastx_chunk(fn, cs, is_upper=False):
    """Yield (reads, n_seqs, n_bases) chunks bounded by `cs` bytes.

    Size accounting matches lq_utils.parse_fastx_chunk (lq_utils.py:263-289):
    sys.getsizeof(name)+sys.getsizeof(seq)+sys.getsizeof(qual), yielding
    when the running size reaches cs; n_seqs/n_bases are cumulative.
    """
    reads = []
    n_seqs = 0
    n_bases = 0
    size = 0
    for name, seq, qual in iter_fastx(fn):
        if qual is not None:
            if is_upper:
                seq = seq.upper()
            reads.append([name, seq, qual])
            size += sys.getsizeof(name) + sys.getsizeof(seq) + sys.getsizeof(qual)
        else:
            if is_upper:
                seq = seq.upper()
            q = "!" * len(seq)
            reads.append([name, seq, q])
            size += sys.getsizeof(name) + sys.getsizeof(seq) + sys.getsizeof(q)
        n_seqs += 1
        n_bases += len(seq)
        if size >= cs:
            yield (reads, n_seqs, n_bases)
            size = 0
            reads = []
    yield (reads, n_seqs, n_bases)


def open_seq_chunk(fn, file_code, is_upper=False, chunk_size=500 * 1024**2):
    """Dispatch chunked reader by format code (cf. lq_utils.py:55-68)."""
    if file_code == FORMAT_BAM:
        from longqc_tpu_torch.io.bam import parse_bam_chunk
        yield from parse_bam_chunk(fn, chunk_size, is_sequel=True,
                                   is_upper=is_upper)
    elif file_code == FORMAT_FAST5:
        from longqc_tpu_torch.io.fast5 import parse_fast5_chunk
        yield from parse_fast5_chunk(fn, chunk_size, is_upper=is_upper)
    elif file_code == FORMAT_SAM:
        logger.error("SAM is not supported.")
        return
    elif file_code in (FORMAT_FASTQ, FORMAT_FASTA):
        yield from parse_fastx_chunk(fn, chunk_size, is_upper=is_upper)
    else:
        logger.error("The input file format is unknown and not supported.")
        return


def write_fastq(fn, reads, is_chunk=False):
    """Append/write reads as 4-line FASTQ (cf. lq_utils.py:352-369)."""
    if not is_chunk and os.path.isfile(fn):
        logger.error("the file %s already exists." % fn)
        return None
    if not reads:
        logger.error("No read to be output")
        return None
    mode = "a" if is_chunk else "w"
    with open(fn, mode) as fq:
        for r in reads:
            if not r:
                continue
            fq.write("@%s\n%s\n+\n%s\n" % (r[0], r[1], r[2]))
    return True


def get_Qx_bases(reads, threshold=10):
    """Count bases with phred >= threshold (cf. lq_utils.py:323-336)."""
    _t = threshold + 33
    num = 0
    if len(reads[0]) < 3:
        return num
    for read in reads:
        q = read[2]
        num += sum(1 for c in q if ord(c) >= _t)
    return num
