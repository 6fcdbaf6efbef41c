"""Shared helpers of the port's tests (tests/test_torch_*.py).

The tests run on the CPU, where every kernel wrapper of
longqc_tpu_torch runs its plain PyTorch version; pytest-xdist runs
several workers, so each worker keeps to two intra-op threads."""

import numpy as np
import torch

torch.set_num_threads(2)


def t32(a):
    """numpy -> int32 CPU tensor (uint32 words keep their bits)."""
    a = np.array(a)                     # a writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False))


def np_(t):
    return t.cpu().numpy()


def rand_reads(rng, n, lo, hi, with_n=True):
    """[name, seq, ""] reads of lo..hi random bases, half of them (with
    with_n) carrying a short N run."""
    reads = []
    for i in range(n):
        ln = rng.randint(lo, hi)
        s = "".join("ACGT"[j] for j in rng.randint(0, 4, ln))
        if with_n and ln > 10 and rng.rand() < 0.5:
            p = rng.randint(0, ln - 5)
            s = s[:p] + "N" * rng.randint(1, 4) + s[p + 3:]
        reads.append(["r%04d" % i, s, ""])
    return reads


def index_triples(ih, irid, ips):
    """Sorted real (hash, rid, pos << 1 | strand) entries of a flat
    index or chunk; the max of the hash lanes' dtype marks the empty
    slots."""
    ih, irid, ips = (np.asarray(a) for a in (ih, irid, ips))
    keep = ih != np.iinfo(ih.dtype).max
    return sorted(zip(ih[keep].tolist(), irid[keep].tolist(),
                      ips[keep].tolist()))


def rand_seq(rng, n, with_n=0.0):
    s = rng.choice(list("ACGT"), size=n)
    if with_n:
        s[rng.random_sample(n) < with_n] = "N"
    return "".join(s)
