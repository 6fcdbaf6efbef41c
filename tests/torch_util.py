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


def rand_seq(rng, n, with_n=0.0):
    s = rng.choice(list("ACGT"), size=n)
    if with_n:
        s[rng.random_sample(n) < with_n] = "N"
    return "".join(s)
