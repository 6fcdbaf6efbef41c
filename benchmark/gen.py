"""Read sets from a seed: the one generator every traffic mix reads.

The read model is a frozen copy of the repository's vectorised test
simulator (`make_genome_fast` / `sample_reads_fast`): substitutions,
deletions and insertions at err * 0.5 / 0.25 / 0.25, junk reads of
random bases, reverse complements, phred 3..40 uniform. What differs is
what a seed may change. Every seed gets the same multiset of read
lengths (a stratified grid over [min_len, max_len]) and the same counts
of junk, reverse, adapter-carrying and control reads, in another order,
so two seeds ask the same amount of work and differ only in content.
"""

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    COMP[_a] = _b

HERE = os.path.dirname(os.path.abspath(__file__))


def make_rng(seed):
    """A RandomState for any whole-number seed (past 32 bits too), or
    for a list of them (a stream of its own for each list)."""
    return np.random.RandomState(np.random.MT19937(seed))


def make_genome(rng, n):
    return BASES[rng.randint(0, 4, n)]


def read_fasta_seq(path):
    """The concatenated sequence of a one-record FASTA file."""
    with open(path) as f:
        return "".join(ln.strip() for ln in f if not ln.startswith(">"))


def _exact_flags(rng, n, share):
    """A boolean mask with exactly round(share * n) entries set, at
    places drawn from rng."""
    flags = np.zeros(n, bool)
    flags[rng.permutation(n)[:int(round(share * n))]] = True
    return flags


def _mutate(rng, seq, err):
    r = rng.random_sample(len(seq))
    sub = r < err * 0.5
    dele = (r >= err * 0.5) & (r < err * 0.75)
    ins = (r >= err * 0.75) & (r < err)
    seq = seq.copy()
    seq[sub] = BASES[rng.randint(0, 4, int(sub.sum()))]
    rep = np.ones(len(seq), np.int64)
    rep[dele] = 0
    rep[ins] = 2
    return np.repeat(seq, rep)


def make_reads(seed, config, traffic):
    """-> list of [name, seq, qual] for a configuration's read model and
    a traffic mix, the same for the same seed.

    config["reads"]: min_len, max_len, err, junk_frac, rev_frac.
    traffic: n_reads, genome_bp, adapter5_share (the configuration's 5'
    adapter, config["settings"]["adp5"], prepended before the errors),
    control_share (reads of the control sequence in `control_fasta`,
    whole, in either strand)."""
    reads = config["reads"]
    rng = make_rng(seed)
    n = int(traffic["n_reads"])
    genome = make_genome(rng, int(traffic["genome_bp"]))
    lo, hi = int(reads["min_len"]), int(reads["max_len"])
    lens = lo + ((np.arange(n) + 0.5) * (hi - lo + 1) / n).astype(np.int64)
    lens = lens[rng.permutation(n)]
    junk = _exact_flags(rng, n, reads["junk_frac"])
    rev = _exact_flags(rng, n, reads["rev_frac"])
    adp = _exact_flags(rng, n, traffic.get("adapter5_share", 0.0))
    ctl = _exact_flags(rng, n, traffic.get("control_share", 0.0)) & ~adp
    adp5 = np.frombuffer((config["settings"].get("adp5") or "").encode()
                         if adp.any() else b"", np.uint8)
    control = None
    if ctl.any():
        control = np.frombuffer(read_fasta_seq(os.path.join(
            HERE, traffic["control_fasta"])).encode(), np.uint8)
    err = float(reads["err"])
    out = []
    for i in range(n):
        ln = int(lens[i])
        if ctl[i]:
            seq = control
            if rev[i]:
                seq = COMP[seq[::-1]]
            seq = _mutate(rng, seq, err)
        elif junk[i]:
            seq = BASES[rng.randint(0, 4, ln)]
        else:
            body = ln - len(adp5) if adp[i] else ln
            start = rng.randint(0, max(1, len(genome) - body))
            seq = genome[start:start + body]
            if rev[i]:
                seq = COMP[seq[::-1]]
            if adp[i]:
                seq = np.concatenate([adp5, seq])
            seq = _mutate(rng, seq, err)
        qual = (rng.randint(3, 41, len(seq)) + 33).astype(np.uint8)
        out.append(["read%06d" % i, seq.tobytes().decode("ascii"),
                    qual.tobytes().decode("ascii")])
    return out


def warmup_reads(seed, config, traffic):
    """The warm-up job's reads: traffic["warmup_reads"] reads of the same
    model from a genome of traffic["warmup_genome_bp"], so the small job
    runs every stage of a timed one at a coverage the fits can take."""
    return make_reads([int(seed), 3], config, dict(
        traffic, n_reads=traffic["warmup_reads"],
        genome_bp=traffic["warmup_genome_bp"]))


def sample_indices(seed, n_reads, n_sample):
    """The overlap entry's query sample: n_sample read indices drawn from
    the seed (a stream apart from the reads'), in ascending order."""
    rng = make_rng([int(seed), 1])
    return np.sort(rng.permutation(n_reads)[:n_sample])


def write_fastq(path, reads):
    with open(path, "w") as f:
        for name, seq, qual in reads:
            f.write("@%s\n%s\n+\n%s\n" % (name, seq, qual))
