"""ctypes bindings to the port's C++ IO runtime (``csrc/fsiio.cpp``).

Counterpart of ``particlemethod_fsi_tpu/io/native.py``.  The library is built
at first use (never at import) by the host C++ compiler into
``particlemethod_fsi_tpu_torch/_build/fsiio-<hash of the source>/`` and loaded
with ``ctypes``.  It is host code, not a kernel.

Where the JAX package swallows every exception on this path, this module does
not: a build that fails raises with the compiler's output, a write that fails
raises ``IOError``.  Only "no compiler found" makes :func:`ensure_built`
return ``None``, and then the callers take their numpy path, which writes the
same bytes.  :func:`writer_name` says which of the two a process uses.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fsiio.cpp"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libfsiio.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib: Optional[ctypes.CDLL] = None
_searched = False  # the compiler search ran and found none


def find_compiler() -> Optional[list]:
    """Command prefix of a host C++ compiler: ``$CXX``, ``g++``, ``c++``,
    ``clang++``, or ``nvcc`` (which drives its own host compiler).  ``None``
    when the machine has none."""
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if name and shutil.which(name):
            return [shutil.which(name), *CXX_FLAGS]
    nvcc = shutil.which("nvcc")
    if nvcc:
        return [nvcc, "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]
    return None


def _declare(lib: ctypes.CDLL) -> None:
    i64, i32p, dp, cp = (
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_char_p,
    )
    lib.fsiio_parse_grid_body.restype = i64
    lib.fsiio_parse_grid_body.argtypes = [cp, i64, i64, i32p, dp, dp, dp]
    lib.fsiio_write_grid.restype = ctypes.c_int32
    lib.fsiio_write_grid.argtypes = [cp, ctypes.c_double, i64, ctypes.c_double,
                                     dp, dp, i32p, dp, dp, dp]
    lib.fsiio_write_vtk.restype = ctypes.c_int32
    lib.fsiio_write_vtk.argtypes = [cp, i64, i32p, dp, dp, dp, dp, dp, dp, dp,
                                    i32p, i32p]
    lib.fsiio_append_scalars.restype = ctypes.c_int32
    lib.fsiio_append_scalars.argtypes = [cp, cp, i64, dp]


def _compile(cmd: list, out_dir: Path) -> Path:
    """Compile the IO runtime with ``cmd`` into ``out_dir``: into a file
    of this process's own, then moved in by rename, so that processes that
    build at once (ranks of a multi-device run) write no file together and
    a reader sees a whole library or none."""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.tmp{os.getpid()}"
    try:
        run = subprocess.run([*cmd, "-o", str(tmp), str(SOURCE)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, timeout=300)
        if run.returncode != 0:
            raise RuntimeError(
                f"building {SOURCE.name} with {cmd[0]} failed:\n{run.stdout}")
        lib_path = out_dir / LIB_NAME
        os.replace(tmp, lib_path)
        return lib_path
    finally:
        tmp.unlink(missing_ok=True)


def ensure_built() -> Optional[ctypes.CDLL]:
    """The IO library, built first if this source has not been built yet;
    ``None`` only where no C++ compiler exists.  A failed build raises."""
    global _lib, _searched
    if _lib is not None:
        return _lib
    if _searched:
        return None
    tag = hashlib.sha256(
        " ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"fsiio-{tag}"
    lib_path = out_dir / LIB_NAME
    if not lib_path.exists():
        cmd = find_compiler()
        if cmd is None:
            _searched = True
            return None
        _compile(cmd, out_dir)
    lib = ctypes.CDLL(str(lib_path))
    _declare(lib)
    _lib = lib
    return _lib


def writer_name() -> str:
    """``"compiled"`` or ``"numpy"``: the writer this process uses."""
    return "compiled" if ensure_built() is not None else "numpy"


def _dptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f64(a):
    return None if a is None else np.ascontiguousarray(a, dtype=np.float64)


def _i32(a):
    return None if a is None else np.ascontiguousarray(a, dtype=np.int32)


def parse_grid_body(text_bytes: bytes, n: int):
    """Parse n body rows; returns (prop, pos, pos0, vel), or None where the
    library cannot be built for want of a compiler."""
    lib = ensure_built()
    if lib is None:
        return None
    prop = np.empty(n, dtype=np.int32)
    pos = np.empty((n, 3), dtype=np.float64)
    pos0 = np.empty((n, 3), dtype=np.float64)
    vel = np.empty((n, 3), dtype=np.float64)
    got = lib.fsiio_parse_grid_body(
        text_bytes, len(text_bytes), n, _iptr(prop), _dptr(pos), _dptr(pos0),
        _dptr(vel))
    if got != n:
        raise ValueError(f"grid parse: expected {n} rows, got {got}")
    return prop, pos, pos0, vel


def write_grid(path, *, time, spacing, domain_min, domain_max, prop, pos,
               pos0, vel) -> bool:
    """Write a ``.grid``/``.prof``; False where there is no compiler."""
    lib = ensure_built()
    if lib is None:
        return False
    # keep the converted arrays alive across the call
    arrs = [_f64(domain_min), _f64(domain_max), _i32(prop), _f64(pos),
            _f64(pos0), _f64(vel)]
    rc = lib.fsiio_write_grid(
        str(path).encode(), float(time), int(arrs[2].shape[0]), float(spacing),
        _dptr(arrs[0]), _dptr(arrs[1]), _iptr(arrs[2]), _dptr(arrs[3]),
        _dptr(arrs[4]), _dptr(arrs[5]))
    if rc:
        raise IOError(f"grid write failed rc={rc}: {path}")
    return True


def write_vtk(path, *, prop, pos, pos0, vel, stress=None, strain=None,
              accel=None, force=None, nbr0_count=None, nbr_count=None,
              extra_scalars=None) -> bool:
    """Write a legacy-ASCII ``.vtk`` with its extra scalar blocks; False
    where there is no compiler."""
    lib = ensure_built()
    if lib is None:
        return False
    prop = _i32(prop)
    n = int(prop.shape[0])
    f = [_f64(a) for a in (pos, pos0, vel, stress, strain, accel, force)]
    counts = [_i32(nbr0_count), _i32(nbr_count)]
    rc = lib.fsiio_write_vtk(
        str(path).encode(), n, _iptr(prop), *[_dptr(a) for a in f],
        *[_iptr(a) for a in counts])
    if rc:
        raise IOError(f"vtk write failed rc={rc}: {path}")
    for name, arr in (extra_scalars or {}).items():
        vals = _f64(np.asarray(arr).reshape(n))
        rc = lib.fsiio_append_scalars(str(path).encode(), name.encode(), n,
                                      _dptr(vals))
        if rc:
            raise IOError(f"vtk write failed rc={rc}: {path} ({name})")
    return True
