"""Python binding of the native netCDF-classic I/O backend (port of the JAX
package's `io/netcdf.py`, over the port's own copy of `io/native/wrfio.cpp`).

The C++ side does the heavy lifting (CDF-2 serialisation, byte swapping,
the asynchronous quilt writer pool); this module only marshals numpy arrays
across `ctypes`.  The library is compiled at first use with
``g++ -O2 -std=c++17 -shared -fPIC -pthread`` into the package's
``build/`` (listed in ``.gitignore``), named by a hash of the source and
the flags, as `ops/build.py` names the kernels' libraries.  If no compiler
is available, `available()` returns False and `io/history.py` writes the
npz container instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from wrfchem_arc_interactions_tpu_torch.ops.build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "wrfio.cpp")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_NC_TYPES = {
    np.dtype(np.int8): 1,
    np.dtype(np.int16): 3,
    np.dtype(np.int32): 4,
    np.dtype(np.float32): 5,
    np.dtype(np.float64): 6,
}
_NP_TYPES = {1: np.int8, 2: np.int8, 3: np.int16, 4: np.int32,
             5: np.float32, 6: np.float64}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None


def lib_path() -> str:
    """Path of the library built from the current source and flags."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"wrfio-{digest[:12]}.so")


def _build_library() -> str:
    so_path = lib_path()
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, so_path)  # atomic: concurrent builders race safely
    return so_path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(_build_library())
        except (OSError, subprocess.CalledProcessError) as e:  # no g++ / load failure
            detail = getattr(e, "stderr", b"") or b""
            _lib_error = f"{e!r} {detail.decode(errors='replace')}".strip()
            return None
        i32, i64, p = ctypes.c_int32, ctypes.c_int64, ctypes.c_char_p
        sigs = {
            "wrfio_create": ([], i64),
            "wrfio_def_dim": ([i64, p, i32], i32),
            "wrfio_put_att_text": ([i64, p, p, p], i32),
            "wrfio_put_att_double": ([i64, p, p, ctypes.c_double], i32),
            "wrfio_put_var": ([i64, p, i32, i32, ctypes.POINTER(i32), ctypes.c_void_p], i32),
            "wrfio_write": ([i64, p], i32),
            "wrfio_write_async": ([i64, p], i32),
            "wrfio_drain": ([], i32),
            "wrfio_open": ([p], i64),
            "wrfio_inq_nvars": ([i64], i32),
            "wrfio_var_name": ([i64, i32, p, i32], i32),
            "wrfio_inq_var": ([i64, p, ctypes.POINTER(i32), ctypes.POINTER(i32),
                               ctypes.POINTER(i64)], i32),
            "wrfio_get_var": ([i64, p, ctypes.c_void_p], i32),
            "wrfio_get_att_double": ([i64, p, ctypes.POINTER(ctypes.c_double)], i32),
            "wrfio_free": ([i64], None),
        }
        for name, (args, res) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native backend compiled and loaded."""
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the native backend did not load (None when it did)."""
    _load()
    return _lib_error


class NetCDFWriter:
    """Build one netCDF-classic file in (C++) memory, then write it —
    synchronously or through the native quilt pool."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native wrfio unavailable: {_lib_error}")
        self._lib = lib
        self._h = lib.wrfio_create()
        self._dims: Dict[Tuple[str, int], int] = {}

    def _dim(self, name: str, length: int) -> int:
        key = (name, length)
        if key not in self._dims:
            did = self._lib.wrfio_def_dim(self._h, name.encode(), length)
            if did < 0:
                raise ValueError(f"bad dimension {name}={length}")
            self._dims[key] = did
        return self._dims[key]

    def put_var(self, name: str, data: np.ndarray, dim_names=None) -> None:
        """Add a variable; the data is copied (byte-swapped) at once."""
        data = np.ascontiguousarray(data)
        if data.dtype == np.int64:  # classic format has no 64-bit int
            data = data.astype(np.int32)
        nct = _NC_TYPES.get(data.dtype)
        if nct is None:
            raise TypeError(f"{name}: unsupported dtype {data.dtype}")
        if dim_names is None:
            dim_names = [f"{name}_d{i}" for i in range(data.ndim)]
        if len(dim_names) != data.ndim:
            raise ValueError(f"{name}: {len(dim_names)} dimension names for "
                             f"{data.ndim} dimensions")
        dimids = (ctypes.c_int32 * max(1, data.ndim))(
            *[self._dim(dn, int(sz)) for dn, sz in zip(dim_names, data.shape)])
        rc = self._lib.wrfio_put_var(
            self._h, name.encode(), nct, data.ndim, dimids,
            data.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"wrfio_put_var({name}) failed: {rc}")

    def put_att(self, name: str, value, var: str = "") -> None:
        if isinstance(value, str):
            rc = self._lib.wrfio_put_att_text(
                self._h, var.encode(), name.encode(), value.encode())
        else:
            rc = self._lib.wrfio_put_att_double(
                self._h, var.encode(), name.encode(), float(value))
        if rc != 0:
            raise RuntimeError(f"wrfio_put_att({name}) failed: {rc}")

    def write(self, path: str, async_write: bool = False) -> None:
        """Write and consume this builder.  Async writes return once the
        file's bytes are built; `drain()` is the completion barrier."""
        fn = self._lib.wrfio_write_async if async_write else self._lib.wrfio_write
        rc = fn(self._h, path.encode())
        self._h = None
        if rc != 0:
            raise RuntimeError(f"wrfio write({path}) failed: {rc}")

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.wrfio_free(self._h)


def drain() -> None:
    """Block until all pending async writes land; raise if any failed."""
    lib = _load()
    if lib is None:
        return
    failed = lib.wrfio_drain()
    if failed:
        raise IOError(f"{failed} asynchronous netCDF write(s) failed")


def read_netcdf(path: str):
    """Read every variable and the global attributes ``_time_s`` and
    ``_step_idx``: (vars dict, attrs dict)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native wrfio unavailable: {_lib_error}")
    h = lib.wrfio_open(path.encode())
    if h < 0:
        raise IOError(f"cannot open netCDF file {path} (rc={h})")
    try:
        out: Dict[str, np.ndarray] = {}
        nvars = lib.wrfio_inq_nvars(h)
        buf = ctypes.create_string_buffer(256)
        for i in range(nvars):
            lib.wrfio_var_name(h, i, buf, 256)
            name = buf.value.decode()
            t = ctypes.c_int32()
            nd = ctypes.c_int32()
            dl = (ctypes.c_int64 * 8)()
            lib.wrfio_inq_var(h, name.encode(), ctypes.byref(t), ctypes.byref(nd), dl)
            shape = tuple(int(dl[k]) for k in range(nd.value))
            arr = np.empty(shape, dtype=_NP_TYPES[t.value])
            rc = lib.wrfio_get_var(h, name.encode(), arr.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise IOError(f"wrfio_get_var({name}) failed: {rc}")
            out[name] = arr
        attrs: Dict[str, float] = {}
        for att in ("_time_s", "_step_idx"):
            v = ctypes.c_double()
            if lib.wrfio_get_att_double(h, att.encode(), ctypes.byref(v)) == 0:
                attrs[att] = v.value
        return out, attrs
    finally:
        lib.wrfio_free(h)
