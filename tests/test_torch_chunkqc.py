"""The port's chunk-QC stages against the JAX package on the CPU: the
sdust screen and mask table, the quality histograms, GC and the adapter
search. Every comparison is exact (flags, counts, rows, distances, ends,
trimmed reads, cut positions, TIE_STATS); meanQ is bit-identical, since
both packages contract the same int32 histograms with q2p in f64 on the
host."""

import random
from collections import Counter

import numpy as np
import pytest
import torch
import torch_util  # noqa: F401

from longqc_tpu.engine import masking as jmask
from longqc_tpu.io.pack import pack_reads as jpack
from longqc_tpu.ops import adapter as jadp
from longqc_tpu.ops import gc as jgc
from longqc_tpu.ops import quality as jq
from longqc_tpu.ops import sdust as jsd
from longqc_tpu_torch import tracing
from longqc_tpu_torch.engine import masking as tmask
from longqc_tpu_torch.io.pack import SEQ_NT4_SDUST, pack_reads
from longqc_tpu_torch.ops import adapter as tadp
from longqc_tpu_torch.ops import gc as tgc
from longqc_tpu_torch.ops import quality as tq
from longqc_tpu_torch.ops import sdust as tsd
from torch_util import adapter_codes, adapter_windows
from util_synth import make_genome, sample_reads

ONT_ADP5 = "AATGTACTTCGTTCAGTTACGTATTGCT"
PB_ADP = "ATCTCTCTCAACAACAACAACGGAGG"


def _qual(rng, n):
    return "".join(chr(33 + q) for q in rng.randint(0, 45, n))


def _low_complexity_reads():
    """Random reads and reads that hold (AT)n, (ACG)n, homopolymers and
    N runs (also straddling the repeats), with qualities."""
    rng = np.random.RandomState(7)
    base = make_genome(rng, 900)
    seqs = [make_genome(rng, n) for n in (40, 300, 700, 1500, 2600)]
    seqs += [
        base[:100] + "AT" * 25 + base[100:500],
        "A" * 70 + base[:300],
        base[:50] + "ACG" * 20 + base[50:400] + "T" * 16,
        ("ACGT" * 10 + "AAAAAAA") * 3,
        base[:80] + "AT" * 12 + "N" + "AT" * 12 + base[80:300],
        "N" * 5 + "A" * 40 + "N" + base[:100],
        base[:200] + "NNNN" + "ACG" * 12 + "NN" + "ACG" * 12 + base[200:600],
        "ACGTN" * 30,
        "",
        "GGC",
    ]
    for i in range(6):
        s = list(make_genome(rng, rng.randint(150, 1800)))
        for _ in range(rng.randint(1, 4)):
            p = rng.randint(0, len(s))
            unit = make_genome(rng, rng.randint(1, 4))
            s[p:p] = list(unit * rng.randint(4, 25))
        for _ in range(rng.randint(0, 3)):
            p = rng.randint(0, len(s))
            s[p:p] = ["N"] * rng.randint(1, 5)
        seqs.append("".join(s))
    return [["s%03d" % i, s, _qual(rng, len(s))] for i, s in enumerate(seqs)]


def test_sdust_screen_flags_equal_jax():
    reads = _low_complexity_reads()
    b = pack_reads(reads, table=SEQ_NT4_SDUST, pad_to=256)
    want = np.asarray(jsd.sdust_screen_batch(b.codes, b.lengths))
    got = tsd.sdust_screen_batch(torch.from_numpy(b.codes),
                                 torch.from_numpy(b.lengths)).numpy()
    assert got.dtype == np.bool_
    assert (got == want).all()
    assert 0 < want.sum() < len(reads)


def test_masked_lengths_equal_jax_and_the_spec():
    reads = _low_complexity_reads()
    want = jsd.masked_lengths(reads)
    got = tsd.masked_lengths(reads, device="cpu")
    assert got.tolist() == want.tolist()
    assert sum(1 for m in want if m) >= 8


def test_native_recursion_equals_the_spec():
    """The C++ recursion (csrc/sdust_native.cpp) against sdust_host, the
    Python specification copied from the JAX package, at the default
    and at other (T, W)."""
    assert tsd.sdust_impl() == "native", tsd.NATIVE_BUILD["error"]
    rng = np.random.RandomState(2)
    reads = _low_complexity_reads() + sample_reads(
        rng, make_genome(rng, 20000), 30, min_len=50, max_len=1500,
        err=0.15, junk_frac=0.1)
    for T, W in ((20, 64), (10, 32), (30, 100)):
        for r in reads if T == 20 else reads[::3]:
            assert tsd.masked_length(r[1], T, W) == \
                jsd.sdust_masked_length(r[1], T, W), (r[0], T, W)


@pytest.fixture(scope="module")
def mask_case():
    """Reads of every kind and the JAX package's mask table rows."""
    reads = _low_complexity_reads()
    rng = np.random.RandomState(3)
    reads += sample_reads(rng, make_genome(rng, 30000), 40, min_len=100,
                          max_len=2500, err=0.12, junk_frac=0.1)
    return reads, jmask.mask_table_rows(reads)


@pytest.mark.parametrize("batch_size", [128, 5])
def test_mask_table_rows_equal_jax(mask_case, batch_size):
    reads, want = mask_case
    got = tmask.mask_table_rows(reads, batch_size=batch_size, device="cpu")
    assert got == want
    assert sum(1 for r in want if r.split("\t")[1] != "0") >= 8


def test_mask_accumulator_writes_the_jax_table(tmp_path, mask_case):
    reads, want = mask_case
    ta = tmask.MaskAccumulator(str(tmp_path / "port"), suffix="s1",
                               device="cpu")
    ta.add_chunk(reads[:10])
    ta.add_chunk(reads[10:])
    ta.close()
    with open(ta.get_outfile_path()) as f:
        assert f.read() == "".join(r + "\n" for r in want)
    assert ta.get_outfile_path().endswith("longqc_sdust_s1.txt")


def test_quality_hist_nqx_and_meanq_exact():
    rng = np.random.RandomState(11)
    reads = [["q%d" % i, "A" * n, _qual(rng, n)]
             for i, n in enumerate(rng.randint(1, 900, 37))]
    # phred values past 126 (clamped) and below 0 (clamped at packing)
    reads.append(["hi", "A" * 5, "".join(chr(c) for c in (33, 40, 126,
                                                          126, 34))])
    b = jpack(reads, pad_to=128)
    tq_, tl = torch.from_numpy(b.quals), torch.from_numpy(b.lengths)
    want = np.asarray(jq.qual_hist_batch(b.quals, b.lengths))
    got = tq.qual_hist_batch(tq_, tl)
    assert got.dtype == torch.int32
    assert (got.numpy() == want).all()
    for thr in (0, 7, 20):
        assert (tq.n_qx_batch(tq_, tl, thr).numpy()
                == np.asarray(jq.n_qx_batch(b.quals, b.lengths, thr))).all()
    mq_want = jq.mean_q_batch(b.quals, b.lengths)
    mq_got = tq.mean_q_batch(tq_, tl)
    assert mq_got.dtype == np.float64
    assert (mq_got == mq_want).all()          # bit-identical
    assert (tq.mean_q_from_hist(got.numpy(), b.lengths) == mq_want).all()


def test_gc_counts_and_accumulator_lists_exact():
    rng = np.random.RandomState(13)
    chunks = [sample_reads(rng, make_genome(rng, 8000), n, min_len=60,
                           max_len=2000, err=0.1, junk_frac=0.2)
              for n in (17, 30)]
    chunks[0][3][1] = "NNNN" + chunks[0][3][1]
    ja = jgc.GCAccumulator(chunk_size=150)
    ta = tgc.GCAccumulator(chunk_size=150, device="cpu")
    for reads in chunks:
        b = jpack(reads)
        want = np.asarray(jgc.gc_count_batch(b.codes, b.lengths))
        got = tgc.gc_count_batch(torch.from_numpy(b.codes),
                                 torch.from_numpy(b.lengths))
        assert got.dtype == torch.int32 and (got.numpy() == want).all()
        ja.add_batch(b)
        ta.add_batch(pack_reads(reads))
    assert ta.r_frac == ja.r_frac and ta.c_frac == ja.c_frac
    assert (ta.r_tot, ta.r_gc_tot, ta.c_tot, ta.c_gc_tot) == \
        (ja.r_tot, ja.r_gc_tot, ja.c_tot, ja.c_gc_tot)
    assert ta.read_mean_sd() == ja.read_mean_sd()
    assert len(ta.c_frac) > 20


class _Draws:
    """A stand-in RandomState whose choice() returns fixed starts."""

    def __init__(self, idx):
        self.idx = np.asarray(idx)

    def choice(self, n, k, replace=False):
        return self.idx[:k]


def test_chunk_gc_window_at_the_read_end():
    """A drawn start of length - 149 passes the overrun test (start +
    149 > length is false): the JAX package then reads past its
    cumulative sum and raises, the port counts the 149 bases left. Any
    earlier start gives both the same window; a later one breaks."""
    codes = np.array([1, 0, 2, 3] * 250, np.uint8)      # 1,000 bases
    n = len(codes)
    end = n - 149
    with pytest.raises(IndexError):
        jgc.chunk_gc_fracs(codes, n, 150, 1.0, _Draws([3, end]))
    fr, g, t = tgc.chunk_gc_fracs(codes, n, 150, 1.0, _Draws([3, end]))
    gc_tail = int(((codes[end:] == 1) | (codes[end:] == 2)).sum())
    assert fr[1] == gc_tail / 150 and t == 300
    assert fr[:1] == jgc.chunk_gc_fracs(codes, n, 150, 1.0, _Draws([3]))[0]
    for idx in ([3, end + 1, 5], [end - 1, 0]):
        assert tgc.chunk_gc_fracs(codes, n, 150, 1.0, _Draws(idx)) == \
            jgc.chunk_gc_fracs(codes, n, 150, 1.0, _Draws(idx))


def _mutate(rng, s, n_sub, n_ins, n_del):
    s = list(s)
    for _ in range(n_sub):
        p = rng.randint(0, len(s))
        s[p] = "ACGT"[(("ACGT".index(s[p])) + 1 + rng.randint(0, 3)) % 4]
    for _ in range(n_ins):
        s.insert(rng.randint(0, len(s) + 1), "ACGT"[rng.randint(0, 4)])
    for _ in range(n_del):
        del s[rng.randint(0, len(s))]
    return "".join(s)


def _adapter_reads(rng, adp, n=40, where="head"):
    """Reads of 100-900 bp with the adapter planted (exact, with
    substitutions, insertions and deletions) at varied offsets near the
    chosen end; some reads are too short for the search (< 300 bp)."""
    reads = []
    for i in range(n):
        ln = rng.randint(100, 900)
        s = make_genome(rng, ln)
        kind = i % 5
        if kind < 4 and ln > 100:
            a = adp if kind == 0 else _mutate(rng, adp, kind, kind // 2,
                                              kind % 2 + kind // 3)
            off = rng.randint(0, 40)
            if where == "head":
                s = s[:off] + a + s[off:]
            else:
                cut = len(s) - off
                s = s[:cut] + a + s[cut:]
        reads.append(["a%03d" % i, s, _qual(rng, len(s))])
    return reads


@pytest.mark.parametrize("adp", [ONT_ADP5, PB_ADP, "ACGTAC"],
                         ids=["ont5", "pb", "short"])
@pytest.mark.parametrize("where", ["head", "tail"])
def test_hw_dist_equals_jax(adp, where):
    rng = np.random.RandomState(len(adp) + (where == "tail"))
    reads = _adapter_reads(rng, adp, where=where)
    want = jadp.adapter_dists(reads, adp, where)
    got = tadp.adapter_dists(reads, adp, where, device="cpu")
    for a, b in zip(got, want):
        assert a.tolist() == b.tolist()
    assert (want[0] == 0).sum() >= 3 and want[2].sum() >= 3


def test_hw_dist_batch_short_windows():
    """Windows shorter than the 150 columns (win_lens < Lw): only the
    window's columns count, and the first optimal end wins."""
    rng = np.random.RandomState(5)
    adp = jadp.encode(ONT_ADP5)
    B, Lw = 24, 150
    windows = rng.randint(0, 4, size=(B, Lw)).astype(np.int32)
    win_lens = rng.randint(0, Lw + 1, size=B).astype(np.int32)
    win_lens[:3] = (0, 1, 27)
    for i in range(3, B, 3):      # adapters inside and across the end
        p = rng.randint(0, Lw - len(adp))
        windows[i, p:p + len(adp)] = adp
    windows[4, 10:10 + len(adp)] = adp    # two exact copies: first wins
    windows[4, 90:90 + len(adp)] = adp
    win_lens[4] = 150
    want = jadp._hw_dist_batch(windows, win_lens, adp, len(adp))
    got = tadp._hw_dist_batch(torch.from_numpy(windows),
                              torch.from_numpy(win_lens),
                              torch.from_numpy(adp), len(adp))
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        assert a.tolist() == np.asarray(b).tolist()
    assert int(got[0][0]) == 10 ** 6 and int(got[1][4]) == 10 + len(adp) - 1


def _cut_both(mod, reads, kw):
    reads = [list(r) for r in reads]
    before = dict(mod.TIE_STATS)
    res = mod.cut_adapter(reads, **kw)
    tie = {k: mod.TIE_STATS[k] - before[k] for k in before}
    return res, reads, tie


@pytest.mark.parametrize("sides", ["head", "tail", "both"])
def test_cut_adapter_equals_jax(sides):
    rng = np.random.RandomState({"head": 1, "tail": 2, "both": 3}[sides])
    a5, a3 = ONT_ADP5, "GCAATACGTAACTGAACGAAGT"
    reads = _adapter_reads(rng, a5 if sides != "tail" else a3,
                           where="tail" if sides == "tail" else "head")
    if sides == "both":
        reads = [[r[0], r[1] + a3 if i % 2 else r[1], r[2] + "I" * len(a3)
                  if i % 2 else r[2]] for i, r in enumerate(reads)]
    kw = {"th": 0.75, "length": 150}
    if sides in ("head", "both"):
        kw["adp_t"] = a5
    if sides in ("tail", "both"):
        kw["adp_b"] = a3
    want, want_reads, want_tie = _cut_both(jadp, reads, kw)
    got, got_reads, got_tie = _cut_both(
        tadp, reads, dict(kw, device="cpu"))
    assert got == want
    assert got_reads == want_reads
    assert got_tie == want_tie and got_tie["candidates"] > 0
    sides_res = want if sides == "both" else (want,)
    assert all(s[1] >= 5 for s in sides_res)


def _host_alignments(adp, wins, lens):
    """The JAX package's per-candidate host functions over the windows:
    (8, C) in hw_align_batch's rows, -1 where they give None."""
    out = []
    for c in range(len(wins)):
        win = wins[c, :lens[c]]
        res = jadp.hw_align_host(adp, win)
        out.append([-1] * 8 if res is None else
                   list(res) + list(jadp.hw_align_optrange(adp, win)[2:]))
    return np.array(out, np.int32).reshape(-1, 8).T


@pytest.mark.parametrize("length", [60, 150])
@pytest.mark.parametrize("m", [18, 28, 45, 64, 100])
def test_hw_align_batch_equals_the_host_functions(m, length):
    """The batched alignment's plain twin (CPU tensors) against the JAX
    package's hw_align_host and hw_align_optrange window by window, all
    eight fields, on every kind of window: random, the adapter planted
    exact and mutated, poly-A, tandem adapter fragments, repeats, N runs,
    windows of 0, 1, 2 and fewer than `length` columns."""
    rng = np.random.RandomState(m * 1000 + length)
    adp = adapter_codes(m)
    wins, lens = adapter_windows(rng, adp, 14, length)
    got = tadp.hw_align_batch(torch.from_numpy(adp), torch.from_numpy(wins),
                              torch.from_numpy(lens))
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, 14)
    assert np.array_equal(got.numpy(), _host_alignments(adp, wins, lens))


@pytest.mark.parametrize("m", [18, 28])
def test_hw_align_batch_tie_heavy_windows_equal_the_host_functions(m):
    """The plain twin against the JAX package's host functions on 240
    tie-heavy windows of 150 columns at the ONT adapters' lengths: the
    adapter mutated, poly-A, tandem copies of an adapter fragment and
    dinucleotide repeats (kinds 2-5 of tests/torch_util.adapter_windows),
    where most cells have more than one optimal move."""
    rng = np.random.RandomState(7 * m)
    adp = adapter_codes(m)
    wins, lens = adapter_windows(rng, adp, 420, 150)
    keep = np.isin(np.arange(420) % 7, (2, 3, 4, 5))
    wins, lens = wins[keep], lens[keep]
    got = tadp.hw_align_batch(torch.from_numpy(adp), torch.from_numpy(wins),
                              torch.from_numpy(lens))
    want = _host_alignments(adp, wins, lens)
    assert np.array_equal(got.numpy(), want)
    # the traceback's choice differs from another optimal path's somewhere
    assert (want[4] != want[5]).any() and (want[6] != want[7]).any()


def _tie_reads(rng, adp, where, n=40):
    """Reads of 320-900 bp whose searched end is tie-heavy in turn:
    poly-A with the adapter mutated inside, tandem copies of an adapter
    fragment, a dinucleotide repeat, the adapter exact, random."""
    reads = []
    for i in range(n):
        s = make_genome(rng, rng.randint(320, 900))
        kind = i % 5
        if kind == 0:
            end = "A" * rng.randint(20, 80) + _mutate(rng, adp, 2, 1, 1)
        elif kind == 1:
            f = rng.randint(0, len(adp) - 6)
            end = adp[f:f + rng.randint(3, 7)] * 30
        elif kind == 2:
            end = "".join(rng.choice(list("ACGT"), 2)) * 60
        elif kind == 3:
            end = adp
        else:
            end = ""
        s = end + s if where == "head" else s + end
        reads.append(["t%03d" % i, s, _qual(rng, len(s))])
    return reads


@pytest.mark.parametrize("sides", ["head", "tail", "both"])
def test_cut_adapter_counters_equal_the_host_loop(sides, monkeypatch):
    """cut_adapter on CPU tensors over tie-heavy reads, from TIE_STATS
    near the 200-candidate limit of the start sampling: its outputs,
    trimmed reads and TIE_STATS deltas equal the JAX package's
    per-candidate loop; adapter.candidates and adapter.straddle_dp equal
    that loop's calls of hw_align_host and hw_align_optrange; no
    candidate is aligned on the card (adapter.align_kernel 0); one
    adapter.align span a side."""
    calls = Counter()
    for name in ("hw_align_host", "hw_align_optrange"):
        monkeypatch.setattr(
            jadp, name, lambda *a, _f=getattr(jadp, name), _n=name:
            (calls.update([_n]), _f(*a))[1])
    for mod in (jadp, tadp):
        monkeypatch.setattr(mod, "TIE_STATS", {
            "candidates": 190, "ambiguous_identity": 0,
            "ambiguous_start": 0})
    rng = np.random.RandomState({"head": 11, "tail": 12, "both": 13}[sides])
    a5, a3 = ONT_ADP5, "GCAATACGTAACTGAACG"
    kw = {"th": 0.75, "length": 150}
    if sides != "tail":
        kw["adp_t"] = a5
        reads = _tie_reads(rng, a5, "head")
    if sides != "head":
        kw["adp_b"] = a3
        reads = _tie_reads(rng, a3, "tail") if sides == "tail" else \
            [[r[0], r[1] + t[1][-300:], ""] for r, t in
             zip(reads, _tie_reads(rng, a3, "tail"))]
    want, want_reads, want_tie = _cut_both(jadp, reads, kw)
    stats = {}
    with tracing.run(stats):
        got, got_reads, got_tie = _cut_both(tadp, reads,
                                            dict(kw, device="cpu"))
    assert got == want
    assert got_reads == want_reads
    assert got_tie == want_tie
    cnt = stats["spans"]["counters"]
    assert cnt["adapter.candidates"] == calls["hw_align_host"] > 0
    assert cnt["adapter.straddle_dp"] == calls["hw_align_optrange"] > 0
    assert cnt.get("adapter.align_kernel", 0) == 0
    assert stats["spans"]["by_name"]["adapter.align"]["n"] == \
        (2 if sides == "both" else 1)


def test_entry_points_default_to_the_card():
    reads = _low_complexity_reads()[:3]
    calls = [lambda: tmask.mask_table_rows(reads),
             lambda: tmask.MaskAccumulator("/nonexistent/never"),
             lambda: tgc.GCAccumulator(),
             lambda: tadp.cut_adapter([list(r) for r in reads],
                                      adp_t=ONT_ADP5),
             lambda: tsd.masked_lengths(reads)]
    for call in calls:
        if torch.cuda.is_available():
            continue
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_reads_of_random_bases_are_mostly_flagged():
    """Why the host recursion runs on most reads: a count of 5 of one
    triplet value among 62 is common in random sequence, so the screen
    flags nearly every read of a few kbp (the JAX screen alike)."""
    random.seed(3)
    reads = [["r%d" % i, "".join(random.choice("ACGT") for _ in range(4000)),
              ""] for i in range(8)]
    b = pack_reads(reads, table=SEQ_NT4_SDUST, with_quals=False)
    flags = tsd.sdust_screen_batch(torch.from_numpy(b.codes),
                                   torch.from_numpy(b.lengths)).numpy()
    assert flags.all()
