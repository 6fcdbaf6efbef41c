"""Configuration: presets, option structs, and QC thresholds.

Mirrors the behavioral contract of the reference CLI:
  - preset table            longQC.py:171-233
  - alert thresholds        longQC.py:141-143, 248-257, 508-517, 783-824
  - overlap-engine defaults minimap2-coverage.c:252-388, map.c:12-44
"""

from dataclasses import dataclass, field
from typing import Optional


def parse_num(s) -> int:
    """Parse numbers with G/M/K suffixes (cf. minimap2-coverage.c:22-31)."""
    if isinstance(s, (int, float)):
        return int(s)
    s = s.strip()
    mult = 1
    if s and s[-1] in "GgMmKk":
        mult = {"g": 10**9, "m": 10**6, "k": 10**3}[s[-1].lower()]
        s = s[:-1]
    return int(float(s) * mult + 0.499)


@dataclass
class IndexOpt:
    """Minimizer index options (cf. mm_idxopt_init, index defaults)."""
    k: int = 12
    w: int = 5
    is_hpc: bool = False
    batch_size: int = 4_000_000_000  # -I: bp per index part
    bucket_bits: int = 14


@dataclass
class MapOpt:
    """Chaining/mapping options (cf. mm_mapopt_init map.c:12-44 and the
    defaults applied in minimap2-coverage.c:302-367)."""
    max_gap: int = 10000          # -g
    min_cnt: int = 3              # -n
    min_chain_score: int = 40     # -m
    min_score_med: int = 40       # -p  (chain score for "medium" class)
    min_score_good: int = 40      # -q  (chain score for lambda2/m_cnts)
    max_chain_skip: int = 25      # -s
    bw: int = 500
    mid_occ_frac: float = 2e-4    # occurrence threshold quantile
    mid_occ: int = 0              # 0 -> computed from index per part
    seed: int = 11


@dataclass
class FltOpt:
    """Overlap geometry filters (cf. minimap2-coverage.c:369-388)."""
    max_overhang: int = 2000      # -a
    min_ovlp: int = 1000          # -l (parsed but unused by lq_cnt_match)
    min_coverage: int = 3         # -c (min depth for reliable regions)
    min_ratio: float = 0.4        # -r


@dataclass
class OverlapConfig:
    index: IndexOpt = field(default_factory=IndexOpt)
    map: MapOpt = field(default_factory=MapOpt)
    flt: FltOpt = field(default_factory=FltOpt)
    filter_mode: bool = False     # --filter (spike-in control mode)
    ava: bool = False             # -X all-vs-all (vs -Y all-vs-sample)

    # coverage saturation cap per read (COVT, minimap2-coverage.h:20)
    covt: int = 150


# Adapter sequences + overlap parameters per platform preset
# (longQC.py:171-233).
@dataclass
class Preset:
    name: str
    pb: bool = False
    sequel: bool = False
    ont: bool = False
    adp5: Optional[str] = None
    adp3: Optional[str] = None
    med_score: int = 0            # -p passed to the overlap engine
    med_score_short: int = 0      # -p for the --short pass
    db_k: int = 12
    db_w: int = 5
    db_k_fast: int = 15
    db_w_fast: int = 5


PRESETS = {
    "pb-rs2": Preset(
        name="pb-rs2", pb=True,
        adp5="ATCTCTCTCTTTTCCTCCTCCTCCGTTGTTGTTGTTGAGAGAGAT",
        adp3="ATCTCTCTCTTTTCCTCCTCCTCCGTTGTTGTTGTTGAGAGAGAT",
        med_score=80, med_score_short=60),
    "pb-sequel": Preset(
        name="pb-sequel", pb=True, sequel=True,
        adp5="ATCTCTCTCAACAACAACAACGGAGGAGGAGGAAAAGAGAGAGAT",
        adp3="ATCTCTCTCAACAACAACAACGGAGGAGGAGGAAAAGAGAGAGAT",
        med_score=80, med_score_short=60),
    "pb-hifi": Preset(
        name="pb-hifi", pb=True, sequel=True,
        adp5="ATCTCTCTCAACAACAACAACGGAGGAGGAGGAAAAGAGAGAGAT",
        adp3="ATCTCTCTCAACAACAACAACGGAGGAGGAGGAAAAGAGAGAGAT",
        med_score=80, db_k=15, db_w=5, db_k_fast=19, db_w_fast=10),
    "ont-ligation": Preset(
        name="ont-ligation", ont=True,
        adp5="AATGTACTTCGTTCAGTTACGTATTGCT",
        adp3="GCAATACGTAACTGAACG",
        med_score=160, med_score_short=140),
    "ont-rapid": Preset(
        name="ont-rapid", ont=True,
        adp5="GTTTTCGCATTTATCGTGAAACGCTTTCGCGTTTTTCGTGCGCCGCTTCA",
        med_score=160, med_score_short=140),
    "ont-1dsq": Preset(
        name="ont-1dsq", ont=True,
        adp5="GGCGTCTGCTTGGGTGTTTAACCTTTTTGTCAGAGAGGTTCCAAGTCAGAGAGGTTCCT",
        adp3="GGAACCTCTCTGACTTGGAACCTCTCTGACAAAAAGGTTAAACACCCAAGCAGACGCCAGCAAT",
        med_score=160, med_score_short=140),
}


# QC alert thresholds (longQC.py:141-143, 256-257, 622-624, 787-816)
NONSENSE_READ_ERROR_THRESHOLD = 0.45
NONSENSE_READ_WARN_THRESHOLD = 0.25
NONSENSE_READ_ERROR_THRESHOLD_PB = 0.2
NONSENSE_READ_WARN_THRESHOLD_PB = 0.15
NONSENSE_READ_ERROR_THRESHOLD_VERY_LOW_COV = 0.1
NONSENSE_READ_WARN_THRESHOLD_VERY_LOW_COV = 0.075
VERY_LOW_COVERAGE_THRESHOLD = 6
Q7_WARN_FRACTION = 0.65
Q7_ERROR_FRACTION = 0.5
ADAPTER_IDENTITY_THRESHOLD = 0.75
ADAPTER_SEARCH_LENGTH = 150
ADAPTER_TRIM5_WARN_FRACTION = 0.3

# Highly-masked read exclusion rules for subsampling (longQC.py:370-371)
MASK_EXCLUDE_LEN_1, MASK_EXCLUDE_FRAC_1 = 500_000, 0.2
MASK_EXCLUDE_LEN_2, MASK_EXCLUDE_FRAC_2 = 10_000, 0.4

# Subsampling defaults (longQC.py:905-907)
DEFAULT_N_SAMPLE = 5000
MAX_N_SAMPLE = 10000
SUBSAMPLE_SEED = 7

# --short mode length threshold (longQC.py:108)
SHORT_LENGTH_THRESHOLD = 500

# Spike-in filter overlap parameters (longQC.py:255)
FILTER_K, FILTER_W, FILTER_HPC, FILTER_MIN_COVERAGE = 15, 10, True, 1
CONTROL_COVERED_FRAC_THRESHOLD = 0.5   # lq_coverage.py:106


def overlap_config_for_sample(preset: Preset, fast: bool = False,
                              index_size="4G", short: bool = False
                              ) -> OverlapConfig:
    """Main all-vs-sample overlap run configuration.

    Reference command line: `-Y -l 0 -q 160 -p <med> [-k -w -I]`
    (longQC.py:177-231, 438-445).
    """
    k = preset.db_k_fast if fast else preset.db_k
    w = preset.db_w_fast if fast else preset.db_w
    if short:
        k, w = 12, 5
    med = preset.med_score_short if short else preset.med_score
    return OverlapConfig(
        index=IndexOpt(k=k, w=w, batch_size=parse_num(index_size)),
        map=MapOpt(min_score_med=med, min_score_good=160),
        flt=FltOpt(min_ovlp=0),
    )


def overlap_config_for_filter() -> OverlapConfig:
    """Spike-in-control filter run: `-Y -Hk15 -w 10 -c 1 -l 0 --filter`
    (longQC.py:255)."""
    return OverlapConfig(
        index=IndexOpt(k=FILTER_K, w=FILTER_W, is_hpc=FILTER_HPC),
        map=MapOpt(),
        flt=FltOpt(min_ovlp=0, min_coverage=FILTER_MIN_COVERAGE),
        filter_mode=True,
    )
