"""Legacy-ASCII VTK writer for ParaView visualization.

Counterpart of ``particlemethod_fsi_tpu/io/vtk_writer.py``
(``write_vtk_file`` with the extra-scalars tail).  Field set mirrors the
reference's ``writeVtkFile`` (``src/main.cpp:984-1189``): POINTS, per-point
``label`` (property id), ``displacement``, ``stress00..22``,
``strain00..22``, ``velocity``, ``accel``, ``Initialneighbor``/``neighbor``
counts, ``force``.  The reference writes the velocity block twice (quirk Q5,
src/main.cpp:1062-1065 and :1169-1173); it is written once here.

Two writers, the same bytes: the compiled IO runtime (``csrc/fsiio.cpp``
through ``io/native.py``) where the machine has a C++ compiler, numpy where
it has none.  The bytes are those of the JAX package's compiled writer with
its extra-scalars tail.  A failure of the compiled writer raises.
"""

from __future__ import annotations

import numpy as np

from particlemethod_fsi_tpu_torch.io import native


def _f32(a):
    """Values as the compiled writer prints them: cast to float, promoted
    back to double by ``%e``."""
    return np.asarray(a, dtype=np.float64).astype(np.float32)


def _write_numpy(path, n, prop, position, initial_position, velocity, stress,
                 strain, acceleration, force, initial_neighbor_count,
                 neighbor_count, extra_scalars) -> None:
    zeros_v = np.zeros((n, 3))

    def rows(f, arr, fmt="%e"):
        if n:
            np.savetxt(f, arr, fmt=fmt)

    def vec_block(f, name, arr):
        f.write(f"\nVECTORS {name} float\n")
        rows(f, _f32(zeros_v if arr is None else arr))

    def tensor_blocks(f, name, t):
        for a in range(3):
            for b in range(3):
                f.write(f"\nSCALARS {name}{a}{b} float\nLOOKUP_TABLE default\n")
                rows(f, np.zeros(n, np.float32) if t is None
                     else _f32(t[:, a, b]))

    def count_block(f, arr):
        rows(f, np.zeros(n, np.int32) if arr is None
             else np.asarray(arr, dtype=np.int32), fmt="%d")

    pos = np.asarray(position, dtype=np.float64)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 2.0\n")
        f.write("Unstructured Grid Example\n")
        f.write("ASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {n} float\n")
        rows(f, _f32(pos))
        f.write(f"CELLS {n} {2 * n}\n")
        f.write("".join(f"1 {i} " for i in range(n)))
        f.write(f"\nCELL_TYPES {n}\n")
        f.write("1 " * n)
        f.write(f"\n\nPOINT_DATA {n}\n")
        f.write("SCALARS label float 1\nLOOKUP_TABLE default\n")
        rows(f, np.asarray(prop, dtype=np.int32), fmt="%d")
        f.write("\nVECTORS displacement float\n")
        rows(f, _f32(pos - np.asarray(initial_position, dtype=np.float64)))
        tensor_blocks(f, "stress", stress)
        tensor_blocks(f, "strain", strain)
        vec_block(f, "velocity", velocity)
        vec_block(f, "accel", acceleration)
        f.write("\nSCALARS Initialneighbor float 1\nLOOKUP_TABLE default\n")
        count_block(f, initial_neighbor_count)
        f.write("SCALARS neighbor float 1\nLOOKUP_TABLE default\n")
        count_block(f, neighbor_count)
        vec_block(f, "force", force)
        for name, arr in (extra_scalars or {}).items():
            f.write(f"\nSCALARS {name} float 1\nLOOKUP_TABLE default\n")
            rows(f, np.asarray(arr, dtype=np.float64).reshape(n))


def write_vtk_file(
    path,
    *,
    prop: np.ndarray,
    position: np.ndarray,
    initial_position: np.ndarray,
    velocity: np.ndarray,
    stress: np.ndarray | None = None,  # [N,3,3]
    strain: np.ndarray | None = None,  # [N,3,3]
    acceleration: np.ndarray | None = None,
    force: np.ndarray | None = None,
    initial_neighbor_count: np.ndarray | None = None,
    neighbor_count: np.ndarray | None = None,
    extra_scalars: dict | None = None,
    use_native: bool = True,
) -> str:
    """Write one ``.vtk`` dump; returns the writer that ran (``"compiled"``
    or ``"numpy"``)."""
    n = int(prop.shape[0])
    if use_native and native.write_vtk(
            path, prop=prop, pos=position, pos0=initial_position,
            vel=velocity, stress=stress, strain=strain, accel=acceleration,
            force=force, nbr0_count=initial_neighbor_count,
            nbr_count=neighbor_count, extra_scalars=extra_scalars):
        return "compiled"
    _write_numpy(path, n, prop, position, initial_position, velocity, stress,
                 strain, acceleration, force, initial_neighbor_count,
                 neighbor_count, extra_scalars)
    return "numpy"
