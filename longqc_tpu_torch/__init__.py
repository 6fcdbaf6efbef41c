"""longqc_tpu_torch — the PyTorch + CUDA port of longqc_tpu.

Same layout and module names as the JAX package (io/, ops/, engine/),
so each module's counterpart is found by name. Plain tensor code is
PyTorch; every Pallas TPU kernel on the ported path is a hand-written
CUDA kernel for Hopper (csrc/, built on first use by ops/_ext) with a
plain PyTorch twin that CPU tensors run. The package never imports jax.

Ported so far: the plain-mode all-vs-sample overlap engine
(engine/device_overlap) behind `python -m longqc_tpu_torch mmcov`.
"""

from longqc_tpu_torch._version import __version__  # noqa: F401
