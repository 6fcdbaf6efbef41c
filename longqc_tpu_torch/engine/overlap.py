"""Overlap-engine dispatcher (port of longqc_tpu/engine/overlap.py).

Plain-mode (k <= 28: int32 hash lanes for 2k <= 30, int64 above) and
HPC (k <= 15) configurations run on the device engine
(engine/device_overlap). HPC with k > 15 raises NotImplementedError, as
in the JAX device engine; the JAX package's batched-chainer v1 path is
not ported.
"""

from longqc_tpu_torch.config import OverlapConfig
from longqc_tpu_torch.engine.device_overlap import overlap_run_device2


def overlap_run_device(target_iter, query_reads, cfg: OverlapConfig,
                       device="cuda", stats=None):
    """Device-path overlap run -> 9-column TSV rows."""
    return overlap_run_device2(target_iter, query_reads, cfg, device=device,
                               stats=stats)
