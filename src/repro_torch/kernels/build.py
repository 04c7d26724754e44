"""Build and load the CUDA kernels of ``repro_torch/csrc/``.

Each ``.cu`` source is compiled by its own ``nvcc`` process (all started
together) into an object for ``sm_90a``; the objects are linked into ONE
shared library with a plain C interface, loaded with ctypes.  No PyTorch
header is included, so a build takes seconds.  The library lands in
``build/repro_torch_kernels/<hash>/`` at the root of the checkout, keyed by
a hash of the sources and flags, so an unchanged tree builds once.

FMA contraction by the compiler is off (``-fmad=false``): a float
operation rounds on its own unless the source asks for a fused
multiply-add (``__fmaf_rn``), which ``chain_dp.cu`` does exactly where the
reference's compiled arithmetic contracts one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Optional

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
SOURCES = ("runtime.cu", "cheap_fused.cu", "bitonic_sort.cu", "chain_dp.cu",
           "event_detect.cu", "pluto_lookup.cu", "segment_sum.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-O3", "-std=c++17", "-fmad=false", "-Xcompiler",
                     "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

_LIB: Optional[ctypes.CDLL] = None
# what the last build printed (nvcc -Xptxas -v resource usage per kernel)
BUILD_LOG: Dict[str, str] = {}
BUILD_SECONDS: Optional[float] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources (if this tree's library is not built yet) and
    return the library's path.  Raises with nvcc's output on failure."""
    global BUILD_SECONDS
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    t0 = time.time()
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    procs = {}
    for name in SOURCES:
        obj = tmp / (pathlib.Path(name).stem + ".o")
        procs[name] = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    objs = [str(tmp / (pathlib.Path(n).stem + ".o")) for n in SOURCES]
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o",
                           str(tmp / LIB_NAME), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    try:
        os.replace(tmp, out_dir)           # atomic: a complete build or none
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)   # a concurrent build won
    BUILD_SECONDS = time.time() - t0
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        I64 = ctypes.c_int64
        handle.repro_cuda_error_string.argtypes = [I]
        handle.repro_cuda_error_string.restype = ctypes.c_char_p
        handle.cheap_fused_rows.argtypes = [P, P, P, P, P, P, I,
                                            CheapParams, P]
        handle.cheap_fused_rows.restype = I
        handle.bitonic_sort_rows.argtypes = [P, P, I, I, I, P]
        handle.bitonic_sort_rows.restype = I
        handle.chain_dp_rows.argtypes = [P, P, P, P, P, I, I, I, F, F, F, P]
        handle.chain_dp_rows.restype = I
        handle.event_detect_rows.argtypes = [P, P, P] + [I] * 8 + [P]
        handle.event_detect_rows.restype = I
        handle.pluto_lookup.argtypes = [P, P, P, I64, I, P]
        handle.pluto_lookup.restype = I
        handle.pluto_lookup_rows.argtypes = [P, P, P, I64, I, I, P]
        handle.pluto_lookup_rows.restype = I
        handle.segment_sum_rows.argtypes = [P, P, P, P, I, I, I, I, P]
        handle.segment_sum_rows.restype = I
        _LIB = handle
    return _LIB


def check(err: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


class CheapParams(ctypes.Structure):
    """Mirror of ``struct CheapParams`` in csrc/cheap_fused.cu."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "S", "E", "H", "tw", "tau2", "eps", "peak_r", "frac_bits",
        "seed_w", "seed_q", "minimizer_r", "levels", "clip_q", "step_q",
        "n_buckets", "n_entries", "thresh_freq", "use_freq", "use_vote",
        "vlog2", "nbins", "thresh_vote")]
