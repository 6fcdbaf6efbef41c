"""GC-fraction statistics (cf. lq_gcfrac.LqGC, lq_gcfrac.py:15-48; port
of longqc_tpu/ops/gc).

Per-read GC fraction plus randomly-placed fixed-size chunk GC fractions
(default 150 bp windows at sample rate 0.2). The reference draws chunk
positions from the *unseeded* global numpy RNG (nondeterministic across
runs); we use a dedicated seeded generator so results are reproducible,
with the same draw structure per read: choice(l, int(l*rate/chunk),
replace=False), breaking at the first index whose window overruns the
read (lq_gcfrac.py:37-47). The draws are host numpy, in the JAX
package's order, so both packages keep the same lists.
"""

import numpy as np
import torch

from longqc_tpu_torch.ops._ext import require_device


def gc_count_batch(codes, lengths):
    """Per-read GC base count (int32) of padded (N, L) code tiles (1=C,
    2=G), tensors of one device."""
    pos = torch.arange(codes.shape[1], dtype=torch.int32,
                       device=codes.device)[None, :]
    mask = pos < lengths[:, None]
    is_gc = ((codes == 1) | (codes == 2)) & mask
    return is_gc.sum(dim=1, dtype=torch.int32)


def read_gc_frac_batch(codes, lengths):
    """(gc_counts, gc_fractions) as numpy: counts on the tiles' device,
    the f64 division on the host (as in the JAX package)."""
    n_gc = gc_count_batch(codes, lengths).cpu().numpy()
    frac = n_gc / np.maximum(lengths.cpu().numpy().astype(np.float64), 1.0)
    return n_gc, frac


def chunk_gc_fracs(codes_row, length, chunk_size, samp_rate, rng):
    """Sampled fixed-window GC fractions for one read (host).

    Returns (fracs list, gc_total, base_total) matching the reference's
    accumulation including its break-on-overrun quirk. A window starting
    at length - chunk_size + 1 passes the overrun test; it counts the
    chunk_size - 1 bases left to the read's end, as a slice to the end
    would (the JAX package indexes past its cumulative sum there and
    raises IndexError).
    """
    n_draw = int((1.0 / chunk_size) * length * samp_rate)
    if n_draw <= 0:
        return [], 0, 0
    idx = rng.choice(length, n_draw, replace=False)
    is_gc = (codes_row[:length] == 1) | (codes_row[:length] == 2)
    cum = np.concatenate([[0], np.cumsum(is_gc, dtype=np.int64)])
    fracs = []
    gc_tot = 0
    tot = 0
    for i in idx:
        if i + chunk_size - 1 > length:
            break
        cgc = int(cum[min(i + chunk_size, length)] - cum[i])
        fracs.append(cgc / chunk_size)
        gc_tot += cgc
        tot += chunk_size
    return fracs, gc_tot, tot


class GCAccumulator:
    """Streaming accumulator over chunks (LqGC-equivalent); the per-read
    counts run on `device`."""

    def __init__(self, chunk_size=150, samp_rate=0.2, seed=7,
                 device="cuda"):
        self.device = require_device(device)
        self.chunk_size = chunk_size
        self.samp_rate = samp_rate
        self.rng = np.random.RandomState(seed)
        self.r_frac = []
        self.c_frac = []
        self.r_tot = 0
        self.r_gc_tot = 0
        self.c_tot = 0
        self.c_gc_tot = 0

    def add_batch(self, batch):
        """Accumulate from a packed ReadBatch (per-read GC on the device,
        chunk sampling on the host)."""
        if batch.n_reads == 0:
            return
        n_gc, frac = read_gc_frac_batch(
            torch.from_numpy(batch.codes).to(self.device),
            torch.from_numpy(batch.lengths).to(self.device))
        self.r_frac.extend(frac.tolist())
        self.r_gc_tot += int(n_gc.sum())
        self.r_tot += int(batch.lengths.sum())
        for i in range(batch.n_reads):
            fr, g, t = chunk_gc_fracs(batch.codes[i], int(batch.lengths[i]),
                                      self.chunk_size, self.samp_rate,
                                      self.rng)
            self.c_frac.extend(fr)
            self.c_gc_tot += g
            self.c_tot += t

    def read_mean_sd(self):
        a = np.asarray(self.r_frac, dtype=np.float64)
        return float(np.mean(a)), float(np.std(a))
