"""Multi-device data parallelism for the overlap engine (port of
longqc_tpu/parallel/mesh.py).

Scaling model (SURVEY.md §2.3 P8, minimap2-coverage.c:434-444): the
reference's only scale axis is per-read-owned accumulator slots (each
thread owns its reads' lambda / m_cnts) with the sample index shared.
Over devices it is the same thing: the part index is copied to each
device, query lanes are split over the devices, and per-read state
(lam / lam2 / m_cnts / interval events) stays on its shard's device
until the host-side finalize. No collective runs in steady state
(engine/device_overlap.DeviceOverlapEngine with `devices=`).

The JAX package's `jax.sharding.Mesh` becomes a plain list of
torch.device; an entry may repeat (["cuda:0"] * 2: two shards on one
card).
"""

import numpy as np
import torch

_BASES = "ACGT"


def make_mesh(n_devices=None, device="cuda"):
    """The run's device list: on CUDA the first n_devices visible cards
    (all of them for None), as jax.devices()[:n] is; a count past the
    visible cards raises. On the CPU, n_devices (default 1) entries of
    torch.device("cpu")."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * (1 if n_devices is None else n_devices)
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available (pass "
                           "device='cpu' to shard over the CPU)")
    n = torch.cuda.device_count()
    if n_devices is not None and n_devices > n:
        raise ValueError("make_mesh: %d devices requested, %d visible"
                         % (n_devices, n))
    return [torch.device("cuda", i)
            for i in range(n if n_devices is None else n_devices)]


def _synthetic_reads(rng, genome_n, n_reads, min_len, max_len, err):
    """Tiny deterministic synthetic read set (mutated genome substrings
    plus junk) for the dryrun; mirrors tests/util_synth.sample_reads."""
    genome = "".join(_BASES[i] for i in rng.randint(0, 4, size=genome_n))
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for i in range(n_reads):
        ln = rng.randint(min_len, max_len)
        if rng.random_sample() < 0.1:
            seq = "".join(_BASES[j] for j in rng.randint(0, 4, size=ln))
        else:
            start = rng.randint(0, max(1, genome_n - ln))
            seq = genome[start:start + ln]
            if rng.random_sample() < 0.5:
                seq = seq.translate(comp)[::-1]
            out = []
            for ch in seq:
                r = rng.random_sample()
                if r < err * 0.5:
                    out.append(_BASES[rng.randint(0, 4)])
                elif r < err * 0.75:
                    pass
                elif r < err:
                    out.append(ch)
                    out.append(_BASES[rng.randint(0, 4)])
                else:
                    out.append(ch)
            seq = "".join(out)
        qual = "".join(chr(33 + q) for q in rng.randint(3, 41,
                                                        size=len(seq)))
        reads.append(["read%05d" % i, seq, qual])
    return reads


def overlap_dryrun(n_devices: int, device="cuda") -> None:
    """Run the production overlap engine lane-sharded over
    make_mesh(n_devices, device) (index copied per device, query lanes
    split) and check that its rows are identical to the host spec's;
    raises AssertionError where they differ."""
    from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, \
        OverlapConfig
    from longqc_tpu_torch.engine import overlap_host as oh
    from longqc_tpu_torch.engine.device_overlap import overlap_run_device2

    devices = make_mesh(n_devices, device)
    rng = np.random.RandomState(42)
    reads = _synthetic_reads(rng, 12000, 72, 500, 1400, 0.12)
    queries = reads[:4 * n_devices]
    cfg = OverlapConfig(index=IndexOpt(k=12, w=5),
                        map=MapOpt(min_score_med=80, min_score_good=160),
                        flt=FltOpt(min_ovlp=0))
    rows = overlap_run_device2(list(reads), queries, cfg, devices=devices,
                               lanes_per_shard=8)
    rows_host = oh.overlap_run(list(reads), queries, cfg,
                               device=devices[0])
    if rows != rows_host:
        raise AssertionError("sharded engine rows diverge from host spec")
