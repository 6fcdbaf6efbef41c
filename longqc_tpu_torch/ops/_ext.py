"""Build and load the hand-written Hopper kernels (csrc/).

`lib()` builds csrc/*.cu (the kernels, behind the plain C interface of
csrc/kernels.h) and csrc/bind.cpp (their PyTorch bindings) with
torch.utils.cpp_extension.load into one extension module under
build/torch_ext/ in the repository root, and returns it. Nothing is
built at import time: the first wrapper that launches a kernel on a
CUDA tensor triggers the build, and a later process reuses it unless a
source or a flag changed.

Each binding launches on the current stream of its tensors' device and
raises on a launch error. LAUNCHES counts kernel launches per kernel
name, incremented by each wrapper right where it launches (and nowhere
else), so a run can show that its main path went through the kernels;
LAUNCH_SHAPES counts the B3 / B4 launches by row shape.
"""

import glob
import os
import shutil
from collections import Counter

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_ext")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a",
              "--fmad=false"]

LAUNCHES = Counter()
# launches by (kernel name, Q, A) of the kernels that count their shapes
LAUNCH_SHAPES = Counter()

_lib = None


def reset_launches():
    LAUNCHES.clear()
    LAUNCH_SHAPES.clear()


def nvcc_path():
    """The CUDA compiler torch.utils.cpp_extension uses."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "longqc_tpu_torch need the CUDA toolkit")
    return found


def lib(verbose=False):
    """The kernel extension module (built on first use)."""
    global _lib
    if _lib is None:
        from torch.utils.cpp_extension import load
        os.makedirs(BUILD_DIR, exist_ok=True)
        _lib = load(name="longqc_kernels",
                    sources=sorted(glob.glob(os.path.join(CSRC, "*.cu")))
                    + [os.path.join(CSRC, "bind.cpp")],
                    build_directory=BUILD_DIR, extra_cflags=["-O3"],
                    extra_cuda_cflags=CUDA_FLAGS, verbose=verbose)
    return _lib


def require_device(device):
    """torch.device for a run; a CUDA device that is not there raises
    (nothing in the port drops to the CPU on its own). A CUDA device
    given without an index gets the caller's current one, so work handed
    to another thread stays on it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s requested but no CUDA device is "
                           "available (pass device='cpu' explicitly to "
                           "run the plain kernel versions)" % device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def require_cuda(*tensors):
    """Wrapper guard: the kernels take contiguous int32 CUDA tensors of
    one device; anything else raises (no silent fallback)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("kernel inputs must share one CUDA device")
        if t.dtype != torch.int32:
            raise TypeError("kernel inputs must be int32, got %s" % t.dtype)
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
