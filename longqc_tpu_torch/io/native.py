"""ctypes bindings for the port's native FASTA/FASTQ reader.

`_load()` compiles longqc_tpu_torch/csrc/fastx_native.cpp with g++ into
build/fastx/ under the repository root on first use (the library's name
carries a digest of the source, the compiler and the flags, so a
changed source or flag builds anew) and loads it. The flags are fixed
here (BUILD_FLAGS: -O3, nothing read from CXXFLAGS or other
environment variables). When the build or the load fails, the failure
is logged as a warning with the compiler's message, `BUILD["error"]`
keeps it, and io/fastx falls back to its pure-Python lexer; which
reader parses is visible in `fastx.reader_name()` and in the `--stats`
JSON of `mmcov`.

The native reader replaces the reference's kseq-based C readers in the
data-loader role: record lexing runs in C++, while chunk-boundary
accounting stays in Python for bit-compatibility with the reference's
chunking.
"""

import ctypes
import hashlib
import os
import subprocess
import time
from logging import getLogger

logger = getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fastx_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "fastx")
CXX = "g++"
BUILD_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
LIBS = ["-lz"]

# what the last build attempt did: library path, compiler command,
# seconds, and the error (None when the library loaded)
BUILD = {"lib": None, "cmd": None, "build_s": 0.0, "error": None}
_lib = None
_tried = False


def _lib_path():
    h = hashlib.sha1()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join([CXX] + BUILD_FLAGS + LIBS).encode())
    return os.path.join(BUILD_DIR,
                        "libfastx_native-%s.so" % h.hexdigest()[:16])


def _build(so):
    """Compile SOURCE into `so` (written to a temporary name first, so
    processes building it at once never load a half-written library)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (so, os.getpid())
    cmd = [CXX] + BUILD_FLAGS + ["-o", tmp, SOURCE] + LIBS
    BUILD["cmd"] = " ".join(cmd)
    t0 = time.time()
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError("%s: %s" % (CXX, e)) from e
    BUILD["build_s"] = time.time() - t0
    if out.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("%s exited %d: %s" % (
            CXX, out.returncode, (out.stderr or out.stdout).strip()))
    os.replace(tmp, so)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        so = _lib_path()
        BUILD["lib"] = so
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
    except (OSError, RuntimeError) as e:
        BUILD["error"] = str(e)
        logger.warning("native FASTA/FASTQ reader unavailable, parsing with "
                       "the pure-Python lexer: %s", e)
        return None
    lib.lqf_open.restype = ctypes.c_void_p
    lib.lqf_open.argtypes = [ctypes.c_char_p]
    lib.lqf_next_batch.restype = ctypes.c_long
    lib.lqf_next_batch.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                   ctypes.c_long]
    for fn in ("lqf_names", "lqf_seqs", "lqf_quals"):
        getattr(lib, fn).restype = ctypes.c_void_p
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("lqf_name_offs", "lqf_seq_offs"):
        getattr(lib, fn).restype = ctypes.POINTER(ctypes.c_long)
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.lqf_has_qual.restype = ctypes.c_int
    lib.lqf_has_qual.argtypes = [ctypes.c_void_p]
    lib.lqf_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available():
    return _load() is not None


def iter_fastx_native(fn, batch_records=4096, batch_bases=64 * 1024 * 1024):
    """Yield (name, seq, qual_or_None) using the native reader."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native reader unavailable: %s" % BUILD["error"])
    h = lib.lqf_open(fn.encode())
    if not h:
        raise IOError("cannot open %s" % fn)
    try:
        while True:
            n = lib.lqf_next_batch(h, batch_records, batch_bases)
            if n < 0:
                raise ValueError("parse error in %s" % fn)
            if n == 0:
                return
            name_offs = lib.lqf_name_offs(h)
            seq_offs = lib.lqf_seq_offs(h)
            names = ctypes.string_at(lib.lqf_names(h),
                                     name_offs[n]).decode("ascii")
            # one decode per batch; ASCII keeps byte offsets as indices
            seqs = ctypes.string_at(lib.lqf_seqs(h),
                                    seq_offs[n]).decode("ascii")
            has_q = lib.lqf_has_qual(h)
            quals = (ctypes.string_at(lib.lqf_quals(h),
                                      seq_offs[n]).decode("ascii")
                     if has_q else None)
            for i in range(n):
                ns, ne = name_offs[i], name_offs[i + 1]
                ss, se = seq_offs[i], seq_offs[i + 1]
                yield (names[ns:ne], seqs[ss:se],
                       quals[ss:se] if has_q else None)
    finally:
        lib.lqf_close(h)
