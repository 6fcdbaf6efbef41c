"""Which reads are spike-in control reads, from the reads alone: the
plain answer that the program's spike-in filter is held to.

The program runs its sample against the control reference and flags a
read whose coverage ratio (column 6 of its row in
spiked_in_control.txt) is 0.5 or more, the rule reference/qc.py's
coverage_stats reads. Here a read is a control read when at least half
of the k-mers of its first `prefix` bases are k-mers of the control
sequence, on either strand: a read copied from the control keeps most
of them at the simulator's error rates, a read of the genome or a junk
read next to none.
"""

import numpy as np

_CODE = np.zeros(256, np.int64)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
    _CODE[_b + 32] = _i


def kmers(seq, k):
    """The 2-bit codes of seq's k-mers, in order (int64)."""
    c = _CODE[np.frombuffer(seq.encode(), np.uint8)]
    if len(c) < k:
        return np.zeros(0, np.int64)
    out = np.zeros(len(c) - k + 1, np.int64)
    for j in range(k):
        out = (out << 2) | c[j:len(c) - k + 1 + j]
    return out


def _revcomp(seq):
    return seq.translate(str.maketrans("ACGTacgt", "TGCAtgca"))[::-1]


def control_names(reads, control_seq, k=15, prefix=2000, share=0.5):
    """Names of the reads ([name, seq, ...]) that are control reads."""
    ctl = np.unique(np.concatenate([kmers(control_seq, k),
                                    kmers(_revcomp(control_seq), k)]))
    out = set()
    for r in reads:
        km = kmers(r[1][:prefix], k)
        if len(km) and np.isin(km, ctl).mean() >= share:
            out.add(r[0])
    return out


def flagged_names(control_rows):
    """The reads the program's spike-in rows flag (coverage ratio 0.5
    or more); an empty set for no rows (None: the filter wrote none)."""
    cols = (r.split("\t") for r in (control_rows or ()) if r)
    return {c[0] for c in cols if float(c[5]) >= 0.5}


def spike_in_bad(job, controls):
    """Reads of a sampleqc job's sample that the spike-in filter got
    wrong: control reads it did not flag, and flagged reads that are not
    control reads (`controls`: control_names of the run's reads)."""
    sample = {r.split("\t")[0] for r in job["rows"]}
    return len((sample & controls) ^ flagged_names(job["control"]))
