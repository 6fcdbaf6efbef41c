"""The port package never imports jax, builds no kernel on import or on
the CPU paths, and never falls back from CUDA to the CPU on its own."""

import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_util  # noqa: F401

from longqc_tpu_torch.config import FltOpt, IndexOpt, MapOpt, OverlapConfig

_PROBE = r"""
import importlib, pkgutil, sys
import torch
import longqc_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(longqc_tpu_torch.__path__,
                                              "longqc_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
# the sampleqc slice's modules are among them
for m in ("io.sampling", "io.stats", "ops.sdust", "ops.gc", "ops.adapter",
          "ops.distfit", "engine.masking", "engine.pipeline",
          "report.coverage", "report.plots", "report.html"):
    assert "longqc_tpu_torch." + m in mods, m
assert "jax" not in sys.modules, "jax imported"
assert not any(m == "longqc_tpu" or m.startswith("longqc_tpu.")
               for m in sys.modules), "JAX package imported"
from longqc_tpu_torch.ops import _ext, extend, ringprop, sketch_cuda, \
    sketch_hpc
from longqc_tpu_torch.engine import device_index as di
# CPU tensors take the plain versions: no kernel build, no launch
packed = di.pack_single_rows(["ACGTTGCAAGGCTTAACCGG" * 20], 512)
words = [di.to_device_words(a, "cpu") for a in packed[:4]]
ints = [torch.from_numpy(a) for a in packed[4:]]
res = sketch_cuda.sketch_tiles(*words, *ints, W=512, k=12, w=5)
assert int(res["emit"].sum()) > 0
z = torch.zeros((2, 256), dtype=torch.int32)
ringprop.peak_pass(z, z, z - 1)
codes = torch.randint(0, 4, (2, 64), dtype=torch.int32)
lens = torch.tensor([64, 50], dtype=torch.int32)
extend.extz_batch(codes, lens, codes, lens, W=8)
comp = sketch_hpc.hpc_compress("AACCCGTTTTNNAG", 5)
assert len(comp[0]) == 8
assert "jax" not in sys.modules, "jax imported"
assert _ext._lib is None and not _ext.LAUNCHES
# the report stage's modules load only where a figure or the HTML is
# drawn, and no table is read with pandas
for m in ("matplotlib", "jinja2", "pandas"):
    assert m not in sys.modules, m + " imported"
print(len(mods))
"""


def test_import_leaves_jax_out_and_builds_nothing():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 40


def test_engine_never_drops_to_cpu_on_its_own():
    from longqc_tpu_torch.engine.device_overlap import DeviceOverlapEngine

    cfg = OverlapConfig(index=IndexOpt(k=12, w=5), map=MapOpt(),
                        flt=FltOpt())
    q = [["q", "ACGT" * 100, ""]]
    if torch.cuda.is_available():
        assert DeviceOverlapEngine(cfg, q).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            DeviceOverlapEngine(cfg, q)       # default device is cuda
    assert DeviceOverlapEngine(cfg, q, device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_cpu_mixed_inputs():
    from longqc_tpu_torch.ops import _ext

    with pytest.raises(ValueError):
        _ext.require_cuda(torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("cfg,match", [
    # the JAX engine's rule: HPC keys ride int32 lanes, so k <= 15
    (OverlapConfig(index=IndexOpt(k=19, w=10, is_hpc=True)), "k <= 15"),
], ids=["hpc"])
def test_unported_configs_raise(cfg, match):
    from longqc_tpu_torch.engine.overlap import overlap_run_device

    with pytest.raises(NotImplementedError, match=match):
        overlap_run_device([], [["q", "ACGT" * 50, ""]], cfg, device="cpu")


def _entry_calls():
    from longqc_tpu_torch import convert
    from longqc_tpu_torch.engine import overlap_host as oh
    from longqc_tpu_torch.ops import extend, sketch_hpc

    reads = [["r", "ACGTTGCAAGGCTTAACCGG" * 20, ""]]
    cfg = OverlapConfig(index=IndexOpt(k=12, w=5), map=MapOpt(),
                        flt=FltOpt())
    codes = np.zeros((2, 16), np.int32)
    lens = np.full(2, 16, np.int32)
    z = np.zeros(4, np.int32)
    arrays = {n: np.zeros((2, 4), np.int32)
              for n in convert.GROUP_ARRAYS + convert.STATE_ARRAYS}
    return {
        "extz_batch": lambda: extend.extz_batch(codes, lens, codes, lens,
                                                W=4),
        "overlap_run": lambda: oh.overlap_run(list(reads), reads, cfg),
        "build_index": lambda: oh.build_index(reads, 12, 5),
        "sketch_reads_device": lambda: oh.sketch_reads_device(reads, 12, 5),
        "sketch_reads_hpc": lambda: sketch_hpc.sketch_reads_hpc(reads, 15,
                                                                10),
        "index_from_arrays": lambda: convert.index_from_arrays(z, z, z, 3),
        "group_from_arrays": lambda: convert.group_from_arrays(arrays),
    }


@pytest.mark.parametrize("name", ["extz_batch", "overlap_run", "build_index",
                                  "sketch_reads_device", "sketch_reads_hpc",
                                  "index_from_arrays", "group_from_arrays"])
def test_entry_points_default_to_the_card(name):
    """With no device given, numpy inputs go to the card: where there is
    none the call raises instead of running on the CPU."""
    call = _entry_calls()[name]
    if torch.cuda.is_available():
        call()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
