"""Overlap-engine dispatcher (port of longqc_tpu/engine/overlap.py).

Plain-mode configurations (2k <= 30, no HPC) run on the device engine
(engine/device_overlap). HPC sketching and wide (2k > 30) hashes are
not ported yet and raise NotImplementedError naming their ROADMAP entry;
the JAX package's batched-chainer v1 path is not ported.
"""

from longqc_tpu_torch.config import OverlapConfig
from longqc_tpu_torch.engine.device_overlap import overlap_run_device2

NOT_PORTED = ("not ported yet (ROADMAP: port queue item 1, the HPC "
              "sketch and the 2k > 30 wide-hash path)")


def overlap_run_device(target_iter, query_reads, cfg: OverlapConfig,
                       device="cuda", stats=None):
    """Device-path overlap run -> 9-column TSV rows."""
    if cfg.index.is_hpc:
        raise NotImplementedError("HPC overlap configurations are "
                                  + NOT_PORTED)
    if 2 * cfg.index.k > 30:
        raise NotImplementedError("overlap configurations with 2k > 30 are "
                                  + NOT_PORTED)
    return overlap_run_device2(target_iter, query_reads, cfg, device=device,
                               stats=stats)
