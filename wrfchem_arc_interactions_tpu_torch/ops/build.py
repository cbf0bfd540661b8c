"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, loaded with `ctypes` (no PyTorch headers,
so a build takes seconds).  Libraries go to ``build/`` inside the package
(listed in ``.gitignore``), named by a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is reused.  `build_all`
starts one ``nvcc`` per source, all at once.

A kernel whose source is generated at run time (the ROS2 gas solver,
written from the mechanism's tables by `ops/ros2_kernel.py`) registers its
text with `register_generated`: the source is written into ``build/`` too
and is then built and loaded like a static one.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so that the
kernels round exactly where their plain PyTorch versions do.  A kernel may
be built without some of them (`DROPPED_FLAGS`): the Mie evaluator drops
``--fmad=false``.  It is held to its plain version within a tolerance, not
bitwise (its coefficients are sums in another order than the plain
version's matrix product anyway), and its time is set by instruction
issue, so a fused multiply-add in place of a multiply and an add counts.
Every other kernel keeps the flag and stays bitwise equal to its plain
version.  A library's name hashes its source and its own flags, so a build
with other flags is never loaded in its place.
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

# kernel name -> flags of NVCC_FLAGS that its library is built without
DROPPED_FLAGS: Dict[str, tuple] = {"mie_cheb_eval": ("--fmad=false",)}

# kernel name -> path of a generated source under build/
_GENERATED: Dict[str, str] = {}

_LOADED: Dict[str, ctypes.CDLL] = {}


def register_generated(name: str, text: str) -> str:
    """Write the generated CUDA source `text` of kernel `name` into
    ``build/<name>.cu`` (unless it is already there) and make `name` known
    to `lib_path`, `build_all` and `load`.  Returns the source's path."""
    if name in SOURCES:
        raise ValueError(f"{name} is a static kernel")
    path = os.path.join(BUILD_DIR, f"{name}.cu")
    if name not in _GENERATED or not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    _GENERATED[name] = path
    return path


def _source(name: str) -> str:
    """Source path of kernel `name`."""
    if name in SOURCES:
        return os.path.join(CSRC_DIR, SOURCES[name])
    if name in _GENERATED:
        return _GENERATED[name]
    raise KeyError(f"unknown kernel {name}: neither a source under csrc/ nor a "
                   "registered generated source")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def nvcc_flags(name: str) -> tuple:
    """The nvcc flags of kernel `name`'s library."""
    dropped = DROPPED_FLAGS.get(name, ())
    return tuple(f for f in NVCC_FLAGS if f not in dropped)


def lib_path(name: str) -> str:
    with open(_source(name), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(nvcc_flags(name)).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:12]}.so")


def build_all(names: Optional[Iterable[str]] = None,
              verbose: bool = False) -> Dict[str, float]:
    """Compile every missing library (by default the static sources and
    every generated source registered so far), one ``nvcc`` per source in
    parallel.

    Returns {name: build seconds} (0.0 for a library that was already
    built).  Raises with the compiler's output if any build fails.  With
    `verbose`, passes ``-Xptxas -v`` and prints the compiler's report of
    registers and spills.
    """
    names = list([*SOURCES, *_GENERATED] if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    times = {name: 0.0 for name in names}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *nvcc_flags(name), *(("-Xptxas", "-v") if verbose else ()),
               "-o", tmp, _source(name)]
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
