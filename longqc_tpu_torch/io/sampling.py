"""Streaming reservoir subsampling, bit-exact with the reference.

The reference resets the numpy RNG to a fixed seed for *every chunk*
(lq_utils.subsample_from_chunk, lq_utils.py:371-411) and draws
len(chunk)+1 uniforms up front; the variate index advances only over
reads not in the exclusion list. Final subsample identity therefore
depends on the chunk boundaries, which io/fastx.py reproduces exactly.
"""

import numpy as np
from logging import getLogger

logger = getLogger(__name__)


def subsample_from_chunk(chunk, cum_n_seq, s_reads, param, s_seed=7,
                         elist=None):
    """Single-pass reservoir (num mode) or Bernoulli (frac mode) sampler.

    chunk:      list of [name, seq, qual]
    cum_n_seq:  number of sequences seen in prior chunks
    s_reads:    reservoir list (length == param when param >= 1)
    param:      sample size (>=1) or sampling fraction (<1)
    """
    frac = 0.0
    num = 0
    n_seqs = cum_n_seq

    if param >= 1.0:
        num = int(param)
        if not s_reads:
            logger.info("reservoir list empty; allocating %d slots", num)
            s_reads = [0] * num
    else:
        frac = param
        a = []

    rng = np.random.RandomState(seed=s_seed)
    h = rng.uniform(size=len(chunk) + 1)

    k = 0
    for read in chunk:
        name = read[0]
        if elist and name in elist:
            continue
        n_seqs += 1
        if num:
            if n_seqs - 1 < num:
                d = n_seqs - 1
            else:
                d = int(h[k] * n_seqs)
            if d < num:
                s_reads[d] = [name, read[1], read[2]]
        elif h[k] < frac:
            a.append([name, read[1], read[2]])
        k += 1

    if num:
        return s_reads
    return s_reads + a
