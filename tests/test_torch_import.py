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
# the sampleqc and runqc slices' modules are among them
for m in ("io.sampling", "io.stats", "ops.sdust", "ops.gc", "ops.adapter",
          "ops.distfit", "engine.masking", "engine.pipeline",
          "report.coverage", "report.plots", "report.html", "platform",
          "platform.rs", "platform.sequel", "platform.nanopore",
          "parallel"):
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
# drawn, no table is read with pandas, and h5py loads with the first
# fast5 file
for m in ("matplotlib", "jinja2", "pandas", "h5py"):
    assert m not in sys.modules, m + " imported"
print(len(mods))
"""


def test_import_leaves_jax_out_and_builds_nothing():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 40


def test_pyproject_lists_every_package_of_the_port():
    """An installed port (pip install .) holds every package directory
    of longqc_tpu_torch."""
    import os
    import tomllib

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        listed = set(tomllib.load(f)["tool"]["setuptools"]["packages"])
    dirs = {os.path.relpath(d, root).replace(os.sep, ".")
            for d, _, files in os.walk(os.path.join(root, "longqc_tpu_torch"))
            if "__init__.py" in files}
    assert {"longqc_tpu_torch.parallel", "longqc_tpu_torch.platform"} <= dirs
    assert dirs <= listed, sorted(dirs - listed)


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
    """The device engine rejects the configuration; the dispatcher runs
    it on the batched-chainer path instead, as the JAX package does."""
    from longqc_tpu_torch.engine.device_overlap import DeviceOverlapEngine
    from longqc_tpu_torch.engine.overlap import overlap_run_device

    q = [["q", "ACGT" * 50, ""]]
    with pytest.raises(NotImplementedError, match=match):
        DeviceOverlapEngine(cfg, q, device="cpu")
    stats = {}
    rows = overlap_run_device([], q, cfg, device="cpu", stats=stats)
    assert len(rows) == 1 and stats["engine"] == "batched_chainer"


def _entry_calls():
    from longqc_tpu_torch import convert
    from longqc_tpu_torch.engine import overlap_host as oh
    from longqc_tpu_torch.engine.overlap import DeviceChainer
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
        "DeviceChainer": DeviceChainer,
        "overlap_run_with_states": lambda: oh.overlap_run_with_states(
            list(reads), reads, cfg),
    }


@pytest.mark.parametrize("name", ["extz_batch", "overlap_run", "build_index",
                                  "sketch_reads_device", "sketch_reads_hpc",
                                  "index_from_arrays", "group_from_arrays",
                                  "DeviceChainer",
                                  "overlap_run_with_states"])
def test_entry_points_default_to_the_card(name):
    """With no device given, numpy inputs go to the card: where there is
    none the call raises instead of running on the CPU."""
    call = _entry_calls()[name]
    if torch.cuda.is_available():
        call()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
