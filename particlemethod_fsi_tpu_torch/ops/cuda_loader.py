"""Build and load the hand-written CUDA kernels in ``csrc/``.

No counterpart in the JAX package (there Pallas compiles the TPU kernels).
The sources have a plain C interface and include no PyTorch header, so
``nvcc`` needs seconds: every ``*.cu`` is compiled to an object for
``sm_90a`` by its own ``nvcc`` process, all started together, and the objects
are linked into one shared library that ``ctypes`` loads.  The build happens
at first use (never at import), from the sources in the package alone, into
``particlemethod_fsi_tpu_torch/_build/<hash of the sources>/`` so that an
edit rebuilds.  A failed build raises with the compiler's output; nothing
falls back.  :func:`build` also makes other builds (another source tree,
or a checking build with ``-D`` defines) for comparisons, and
:func:`using` sends the wrappers' launches to one of them for a block of
code; the solver uses neither.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libfsi_kernels.so"

# no -use_fast_math: the viscosity term needs 2/(inf + x) == 0 and the pair
# masks need rij2 > 0 exactly
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None


def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "cannot be built on this machine")


def _source_hash(files, flags) -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *flags)).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _build(sources, out_dir: Path, flags) -> Path:
    """Compile and link into ``out_dir``.  Objects, log and library are
    written in a directory of this process's own, and the library and the
    log then move into ``out_dir`` by rename: several processes that find
    no library (ranks of a multi-device run) may build at once without
    writing one file together, and a reader sees a whole library or none."""
    nvcc = _find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f"obj{os.getpid()}.", dir=out_dir))
    try:
        procs = []
        for src in sources:
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *flags, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log))
        (work / "build.log").write_text("\n".join(log))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(work / LIB_NAME),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(work / "build.log", out_dir / "build.log")
        lib = out_dir / LIB_NAME
        os.replace(work / LIB_NAME, lib)
        return lib
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.fsi_phase1_sweep.restype = ci
    lib.fsi_phase1_sweep.argtypes = [
        ci, vp, vp, vp, vp, vp, vp, vp,  # is_double, pos vel key prop ws wl out
        ci, ci, ci, ip, dp, dp,  # n block n_off offs consts ratio
        ci, ci, ci, ci, ci, vp,  # planar st with_ratio uniform_radii count stream
    ]
    lib.fsi_phase2_sweep.restype = ci
    lib.fsi_phase2_sweep.argtypes = [
        ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,  # .. invmu ws wl out
        ci, ci, ci, ip, dp, dp, dp,  # n block n_off offs consts ratio cof_a
        ci, ci, ci, ci, vp,  # planar st uniform_ratio uniform_radii stream
    ]
    # the virial sweep takes the argument list of phase 2
    lib.fsi_virial_sweep.restype = ci
    lib.fsi_virial_sweep.argtypes = list(lib.fsi_phase2_sweep.argtypes)
    # the row-major entry points (kernels 4-6): the sorted key finds the
    # ring runs; the ring's geometry (offs_yz, domain_min + cell_width,
    # cell_count) in place of offs
    lib.fsi_phase2_rows.restype = ci
    lib.fsi_phase2_rows.argtypes = [
        ci, vp, vp, vp, vp,  # is_double, pos vel key prop
        vp, vp, vp, vp, vp, vp, vp,  # pp pa gc mu ws wl out
        ci, ci, ci, ip, dp, ip,  # n block n_off offs_yz geom ncell
        dp, dp, dp, ctypes.c_double,  # consts ratio cof_a support2
        ci, ci, ci, ci, vp,  # planar st uniform_ratio uniform_radii stream
    ]
    # the row-major virial takes the argument list of the row-major phase 2
    lib.fsi_virial_rows.restype = ci
    lib.fsi_virial_rows.argtypes = list(lib.fsi_phase2_rows.argtypes)
    lib.fsi_phase1_rows.restype = ci
    lib.fsi_phase1_rows.argtypes = [
        ci, vp, vp, vp, vp, vp, vp, vp,  # is_double, pos vel key prop ws wl out
        ci, ci, ci, ip, dp, ip, dp, dp,  # n block n_off offs_yz geom ncell consts ratio
        ci, ci, ci, ci, vp,  # planar st with_ratio uniform_radii stream
    ]
    # the occupancy queries and, in a checking build (-DFSI_WALK_COUNT)
    # only, the walk counts; a build of another tree for a comparison may
    # lack some of them
    for phase in ("phase1", "phase2", "virial"):
        occupancy = getattr(lib, f"fsi_{phase}_occupancy", None)
        if occupancy is not None:
            occupancy.restype = ci
            occupancy.argtypes = [ci, ci, ci, ci, ci]  # dbl rows planar st block
        counts = getattr(lib, f"fsi_{phase}_counts", None)
        if counts is not None:
            counts.restype = ci
            counts.argtypes = [vp]  # unsigned long long out[3], host memory
    lib.fsi_bf16_microbench.restype = ci
    lib.fsi_bf16_microbench.argtypes = [
        ci, vp, vp, vp, ci, ci, ci, ci, vp,  # bf16 x y out b w reps blocks stream
    ]
    lib.fsi_bf16_microbench_terms.restype = ci
    lib.fsi_bf16_microbench_terms.argtypes = [
        ci, vp, vp, vp, ci, ci, vp,  # bf16 x y out n trip stream
    ]
    lib.fsi_virial_nconst.restype = ci
    lib.fsi_virial_nconst.argtypes = []
    lib.fsi_phase1_nconst.restype = ci
    lib.fsi_phase1_nconst.argtypes = []
    lib.fsi_phase2_nconst.restype = ci
    lib.fsi_phase2_nconst.argtypes = []


def build(csrc: Path = CSRC_DIR, defines=()) -> ctypes.CDLL:
    """The kernels' shared library built from the sources under ``csrc``,
    with ``-D<name>`` for each of ``defines``, into
    ``_build/<hash of the sources and flags>/`` (reused where it exists)."""
    sources = sorted(Path(csrc).glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {csrc}")
    flags = tuple(f"-D{d}" for d in defines)
    out_dir = BUILD_ROOT / _source_hash(
        sources + sorted(Path(csrc).glob("*.cuh")), flags)
    lib_path = out_dir / LIB_NAME
    if not lib_path.exists():
        _build(sources, out_dir, flags)
    lib = ctypes.CDLL(str(lib_path))
    _declare(lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if this source tree has not
    been built yet."""
    global _lib
    if _lib is None:
        _lib = build()
    return _lib


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """Within the block, :func:`load` returns ``lib`` (a library of
    :func:`build`), so the wrappers launch its kernels: for checks and
    comparisons of builds on the same inputs."""
    global _lib
    saved = load()
    _lib = lib
    try:
        yield lib
    finally:
        _lib = saved


def build_log() -> str:
    """The compiler's output of the build in use (registers, shared memory
    and spills of each kernel, from ``-Xptxas -v``)."""
    return (Path(load()._name).parent / "build.log").read_text()


def sass(lib: ctypes.CDLL) -> dict:
    """name -> machine code of each kernel function of a built library
    (``cuobjdump -sass``, beside ``nvcc``), one stripped line a line."""
    cuobjdump = Path(_find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", lib._name],
                          capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None and line.strip():
            funcs[name].append(line.strip())
    return {k: "\n".join(v) for k, v in funcs.items()}
