"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, loaded with `ctypes` (no PyTorch headers,
so a build takes seconds).  Libraries go to ``build/`` inside the package
(listed in ``.gitignore``), named by a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is reused.  `build_all`
starts one ``nvcc`` per source, all at once.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so that the
kernels round exactly where their plain PyTorch versions do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

# kernel name -> source file under csrc/
SOURCES = {"advect_scalar_5_3": "advect_scalar_5_3.cu",
           "mie_cheb_eval": "mie_cheb_eval.cu",
           "advect_tracers": "advect_tracers.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:12]}.so")


def build_all(names: Optional[Iterable[str]] = None,
              verbose: bool = False) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source in parallel.

    Returns {name: build seconds} (0.0 for a library that was already
    built).  Raises with the compiler's output if any build fails.  With
    `verbose`, passes ``-Xptxas -v`` and prints the compiler's report of
    registers and spills.
    """
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    times = {name: 0.0 for name in names}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {name}]\n{log.strip()}")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing."""
    if name not in _LOADED:
        path = lib_path(name)
        if not os.path.exists(path):
            build_all([name])
        _LOADED[name] = ctypes.CDLL(path)
    return _LOADED[name]
