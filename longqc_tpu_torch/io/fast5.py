"""Multi-read FAST5 ingestion (h5py-gated).

Behavioral contract: lq_utils.parse_fast5_chunk (lq_utils.py:211-236)
and lq_nanopore.open_fast5 / get_fastq_from_multi_fast5
(lq_nanopore.py:102-117). The chunk-boundary accounting (python object
sizes of name/seq/qual vs the byte budget) is part of the bit-exactness
contract: the seed-7 reservoir sampler runs per chunk, so a different
boundary would sample a different read set. Structure here is our own:
a flat record iterator feeding a generic byte-budget batcher. h5py is
imported on the first open, so the module loads where it is missing.
"""

import os
import sys
from logging import getLogger

logger = getLogger(__name__)

# basecall group holding the fastq payload of one read in a multi-fast5
_FASTQ_PATH = "Analyses/Basecall_1D_000/BaseCalled_template/Fastq"


def open_fast5(path):
    try:
        import h5py
    except ImportError:
        raise RuntimeError("h5py is required for fast5 input") from None
    return h5py.File(path, "r")


def is_multi_fast5(path):
    with open_fast5(path) as f:
        return "/UniqueGlobalKey" not in f


def list_toplevel(f):
    return list(f.keys())


def get_fastq_from_multi_fast5(f, rn):
    return f[rn][_FASTQ_PATH][()].decode("ascii")


def iter_fast5_records(dn, is_upper=False):
    """Flat [name, seq, qual] stream over every read_* group of every
    .fast5 file in a directory (os.listdir order, matching the
    reference's traversal)."""
    for fname in os.listdir(dn):
        if not fname.endswith(".fast5"):
            continue
        with open_fast5(os.path.join(dn, fname)) as fh:
            for grp in list_toplevel(fh):
                if not grp.startswith("read_"):
                    continue
                lines = get_fastq_from_multi_fast5(fh, grp).splitlines()
                name = lines[0].split(" ")[0]
                seq = lines[1].upper() if is_upper else lines[1]
                yield name, seq, lines[1], lines[3]


def parse_fast5_chunk(dn, cs, is_upper=False):
    """Yield (reads, n_seqs, n_bases) chunks from a dir of multi-fast5.

    n_seqs/n_bases accumulate across the whole directory (not reset per
    chunk) and the budget counts getsizeof of the name, the RAW seq
    (pre-uppercase) and the qual string — both reference quirks the
    sampler's bit-exactness depends on."""
    batch, used = [], 0
    n_seqs = n_bases = 0
    for name, seq, raw_seq, qual in iter_fast5_records(dn, is_upper):
        batch.append([name, seq, qual])
        n_seqs += 1
        n_bases += len(raw_seq)
        used += (sys.getsizeof(name) + sys.getsizeof(raw_seq)
                 + sys.getsizeof(qual))
        if used >= cs:
            yield batch, n_seqs, n_bases
            batch, used = [], 0
    yield batch, n_seqs, n_bases
