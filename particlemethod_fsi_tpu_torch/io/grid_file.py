"""Reader/writer for ``.grid`` scene files and ``.prof`` restart snapshots.

Counterpart of ``particlemethod_fsi_tpu/io/grid_file.py``.  Both formats are
identical by design (the reference's ``writeProfFile`` emits exactly the
``readGridFile`` input format, ``src/main.cpp:957-982`` vs ``:788-904``),
which is what makes any ``.prof`` a valid restart input:

    line 1:  Time
    line 2:  N  spacing  xmin xmax  ymin ymax  zmin zmax
    lines 3..N+2:  prop  x y z  x0 y0 z0  vx vy vz

The body goes through the compiled IO runtime (``io/native.py``) where the
machine has a C++ compiler, and through numpy where it has none; both write
the same bytes and read the same values.  A failure of the compiled path
raises: it never falls through to numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GridData:
    """Host-side particle snapshot (numpy, float64)."""

    time: float
    spacing: float
    domain_min: np.ndarray  # [3]
    domain_max: np.ndarray  # [3]
    prop: np.ndarray  # [N] int32
    position: np.ndarray  # [N,3]
    initial_position: np.ndarray  # [N,3]
    velocity: np.ndarray  # [N,3]

    @property
    def n(self) -> int:
        return int(self.prop.shape[0])

    def particle_volume(self, two_dimensional: bool) -> float:
        """ParticleVolume = spacing^d (src/main.cpp:805-809)."""
        d = 2 if two_dimensional else 3
        return float(self.spacing) ** d


def read_grid_file(path, *, use_native: bool = True) -> GridData:
    with open(path, "rb") as f:
        time = float(f.readline().split()[0])
        header = f.readline().split()
        n = int(header[0])
        spacing = float(header[1])
        dmin = np.array([float(header[2]), float(header[4]), float(header[6])])
        dmax = np.array([float(header[3]), float(header[5]), float(header[7])])
        body_bytes = f.read()

    parsed = None
    if use_native:
        from particlemethod_fsi_tpu_torch.io import native

        parsed = native.parse_grid_body(body_bytes, n)
    if parsed is None:
        body = np.loadtxt(
            body_bytes.decode().splitlines(), dtype=np.float64, max_rows=n, ndmin=2
        )
        if body.shape != (n, 10):
            raise ValueError(
                f"grid file {path}: expected {n}x10 body, got {body.shape}"
            )
        parsed = (body[:, 0].astype(np.int32),
                  np.ascontiguousarray(body[:, 1:4]),
                  np.ascontiguousarray(body[:, 4:7]),
                  np.ascontiguousarray(body[:, 7:10]))
    prop, pos, pos0, vel = parsed
    return GridData(
        time=time,
        spacing=spacing,
        domain_min=dmin,
        domain_max=dmax,
        prop=prop,
        position=pos,
        initial_position=pos0,
        velocity=vel,
    )


def write_grid_file(grid: GridData, path, *, generator_style: bool = False,
                    use_native: bool = True) -> None:
    """Write a ``.grid``/``.prof`` file.

    ``generator_style=True`` reproduces the generator's header/row formatting
    (``%lf`` time, triple-space separators, Position duplicated as
    InitialPosition, ``generator/generator.cpp:839-862``); the default mirrors
    the solver's ``writeProfFile`` formatting (src/main.cpp:961-978) and goes
    through the compiled writer where there is one.
    """
    if not generator_style and use_native:
        from particlemethod_fsi_tpu_torch.io import native

        if native.write_grid(
            path, time=grid.time, spacing=grid.spacing,
            domain_min=grid.domain_min, domain_max=grid.domain_max,
            prop=grid.prop, pos=grid.position,
            pos0=grid.initial_position, vel=grid.velocity,
        ):
            return
    dmin, dmax = grid.domain_min, grid.domain_max
    bounds = (dmin[0], dmax[0], dmin[1], dmax[1], dmin[2], dmax[2])
    prop = np.asarray(grid.prop, dtype=np.float64)[:, None]
    with open(path, "w") as f:
        if generator_style:
            f.write(f"{grid.time:f}\n")
            f.write("%d %e  %e %e %e  %e %e %e\n" % (grid.n, grid.spacing, *bounds))
            body = np.hstack([prop, grid.position, grid.position, grid.velocity])
            row = "%d   %e %e %e %e %e %e  %e %e %e "
        else:
            f.write(f"{grid.time:e}\n")
            f.write("%d %e %e %e %e %e %e %e\n" % (grid.n, grid.spacing, *bounds))
            body = np.hstack([prop, grid.position, grid.initial_position,
                              grid.velocity])
            row = "%d %e %e %e %e %e %e  %e %e %e"
        if grid.n:
            np.savetxt(f, body, fmt=row)


def segment_counts(prop: np.ndarray) -> dict:
    """Count particles per role segment (src/main.cpp:916-944)."""
    return {
        "fluid": int(np.sum((0 <= prop) & (prop < 2))),
        "structure": int(np.sum((2 <= prop) & (prop < 4))),
        "wall": int(np.sum((4 <= prop) & (prop < 6))),
    }
