"""The generator: the same seed gives the same reads; every seed the
same sizes and counts."""

from collections import Counter

import numpy as np

from benchmark import gen

CFG = {"reads": {"min_len": 300, "max_len": 900, "err": 0.12,
                 "junk_frac": 0.1, "rev_frac": 0.5},
       "settings": {"adp5": "AATGTACTTCGTTCAGTTACGTATTGCT"}}
TR = {"n_reads": 60, "genome_bp": 20000, "adapter5_share": 0.1,
      "control_share": 0.05, "control_fasta": "traffic/sequel_control.fasta"}
BIG = 2 ** 31 + 987654321


def test_same_seed_same_reads():
    assert gen.make_reads(BIG, CFG, TR) == gen.make_reads(BIG, CFG, TR)
    assert gen.make_reads(BIG, CFG, TR) != gen.make_reads(BIG + 1, CFG, TR)


def test_seeds_past_32_bits():
    for s in (0, 2 ** 32 + 5, 2 ** 40):
        assert len(gen.make_reads(s, CFG, TR)) == TR["n_reads"]


def test_every_seed_the_same_lengths_before_errors():
    cfg = {"reads": dict(CFG["reads"], err=0.0), "settings": CFG["settings"]}
    tr = dict(TR, adapter5_share=0.0, control_share=0.0)
    a = Counter(len(r[1]) for r in gen.make_reads(1, cfg, tr))
    b = Counter(len(r[1]) for r in gen.make_reads(BIG, cfg, tr))
    assert a == b


def test_exact_adapter_and_control_counts():
    cfg = {"reads": dict(CFG["reads"], err=0.0, junk_frac=0.0,
                         rev_frac=0.0), "settings": CFG["settings"]}
    for s in (3, BIG):
        reads = gen.make_reads(s, cfg, TR)
        adp = CFG["settings"]["adp5"]
        assert sum(r[1].startswith(adp) for r in reads) >= 6
        ctl = gen.read_fasta_seq(gen.os.path.join(gen.HERE,
                                                  TR["control_fasta"]))
        assert sum(r[1] == ctl for r in reads) == 3


def test_sample_indices():
    a = gen.sample_indices(BIG, 100, 30)
    assert np.array_equal(a, gen.sample_indices(BIG, 100, 30))
    assert len(set(a.tolist())) == 30 and list(a) == sorted(a)
