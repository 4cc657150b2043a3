"""Scene generator: shape primitives -> :class:`GridData` (NumPy lattice fills).

Counterpart of ``particlemethod_fsi_tpu/generator.py`` (itself a
re-implementation of the reference's generator executable,
``generator/generator.cpp``): :class:`Primitive`, :class:`BoidScene`,
:func:`parse_boid_file`, :func:`generate_grid` with all six primitives,
:func:`generate_case` and the ``main()`` command line
(``python -m particlemethod_fsi_tpu_torch.generator <case>`` reads
``<case>.boid`` and writes ``<case>.grid``).

Behavioral contract (identical to the JAX package's generator):

* ``.boid`` grammar: global ``ParticleDistance`` / ``LowerDomain`` /
  ``UpperDomain`` plus ``Start<Primitive>..End<Primitive>`` blocks
  (generator.cpp:128-184) for the six primitives.
* lattice: per-axis count = round(extent/spacing); effective spacing =
  extent/count; offset 0.5*spacing (Cuboid/Cyboid) or 0.01*spacing (the "2"
  variants and Recboid, x/y only) (generator.cpp:654-835).  Loop order is
  x-outer, y-mid, z-inner, and primitives are emitted group-by-group in the
  fixed order Cuboid, Cuboid2, Cyboid, Cyboid2, Recboid, Recboid2 -- not
  list order.
* output rows duplicate Position as InitialPosition (quirk Q6,
  generator.cpp:851-857).
* Recboid2 appends every lattice point and rotation uses the literal constant
  3.1415/180 for degrees->radians (generator.cpp:784,810), kept for
  trajectory parity.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import numpy as np

from particlemethod_fsi_tpu_torch.io.grid_file import GridData, write_grid_file


@dataclass
class Primitive:
    kind: str  # Cuboid | Cuboid2 | Cyboid | Cyboid2 | Recboid | Recboid2
    spacing: float = 0.0
    type: int = 0
    rigid_type: int = 0
    lower: tuple[float, float, float] = (0.0, 0.0, 0.0)
    upper: tuple[float, float, float] = (0.0, 0.0, 0.0)
    velocity: tuple[float, float, float] = (0.0, 0.0, 0.0)
    enthalpy: float = 0.0
    ratio: float = 0.0  # Cyboid/Cyboid2
    angle: float = 0.0  # Recboid/Recboid2 (degrees)


@dataclass
class BoidScene:
    particle_distance: float
    lower_domain: tuple[float, float, float]
    upper_domain: tuple[float, float, float]
    primitives: list[Primitive] = field(default_factory=list)


_PRIMITIVES = ("Cuboid", "Cuboid2", "Cyboid", "Cyboid2", "Recboid", "Recboid2")
# Longest-name-first for Start/End token matching ("StartCuboid2" contains "StartCuboid")
_PRIM_MATCH_ORDER = sorted(_PRIMITIVES, key=len, reverse=True)


def parse_boid_file(path_or_text, *, is_text: bool = False) -> BoidScene:
    if is_text:
        text = str(path_or_text)
    else:
        with open(path_or_text) as f:
            text = f.read()
    # the reference tokenizes with fscanf(%s) inside blocks; comments (#) only
    # apply at line level outside blocks (generator.cpp:134-137)
    tokens: list[str] = []
    for line in text.splitlines():
        if line.lstrip().startswith("#"):
            continue
        tokens.extend(line.split())

    scene = BoidScene(particle_distance=-1.0, lower_domain=(0, 0, 0), upper_domain=(0, 0, 0))
    i = 0

    def take_floats(n):
        nonlocal i
        vals = tuple(float(tokens[i + k]) for k in range(n))
        i += n
        return vals

    while i < len(tokens):
        tok = tokens[i]
        i += 1
        if tok == "ParticleDistance":
            scene.particle_distance = take_floats(1)[0]
        elif tok == "LowerDomain":
            scene.lower_domain = take_floats(3)
        elif tok == "UpperDomain":
            scene.upper_domain = take_floats(3)
        else:
            kind = next(
                (p for p in _PRIM_MATCH_ORDER if tok == f"Start{p}"), None
            )
            if kind is None:
                continue
            prim = Primitive(kind=kind)
            end = f"End{kind}"
            while i < len(tokens) and tokens[i] != end:
                key = tokens[i]
                i += 1
                if key == "Spacing":
                    prim.spacing = take_floats(1)[0]
                elif key == "Type":
                    prim.type = int(tokens[i]); i += 1
                elif key == "RigidType":
                    prim.rigid_type = int(tokens[i]); i += 1
                elif key == "Lower":
                    prim.lower = take_floats(3)
                elif key == "Upper":
                    prim.upper = take_floats(3)
                elif key == "Velocity":
                    prim.velocity = take_floats(3)
                elif key == "Enthalpy":
                    prim.enthalpy = take_floats(1)[0]
                elif key == "Ratio":
                    prim.ratio = take_floats(1)[0]
                elif key == "Angle":
                    prim.angle = take_floats(1)[0]
                else:
                    raise ValueError(f"no such indication in {kind}: {key!r}")
            i += 1  # skip End token
            scene.primitives.append(prim)
    return scene


def _axis_lattice(lo: float, hi: float, space: float, offset: float) -> np.ndarray:
    """1-D lattice: n = round(extent/space) points at lo + (k+offset)*sp with
    sp = extent/n (generator.cpp:660-665)."""
    width = hi - lo
    n = int(round(width / space))
    if n <= 0:
        return np.zeros((0,), dtype=np.float64)
    sp = width / n
    return lo + (np.arange(n, dtype=np.float64) + offset) * sp


def _lattice3(prim: Primitive, offsets: tuple[float, float, float]):
    """Full 3-D lattice in the reference's x-outer, y-mid, z-inner order."""
    ax = [
        _axis_lattice(prim.lower[d], prim.upper[d], prim.spacing, offsets[d])
        for d in range(3)
    ]
    px, py, pz = np.meshgrid(ax[0], ax[1], ax[2], indexing="ij")
    return np.stack([px.ravel(), py.ravel(), pz.ravel()], axis=1)


def generate_particles(scene: BoidScene):
    """Run all primitive fills; returns (type[N], pos[N,3], vel[N,3],
    rigid_type[N], enthalpy[N])."""
    types, positions, velocities, rigids, enthalpies = [], [], [], [], []

    def emit(prim: Primitive, pts: np.ndarray):
        m = pts.shape[0]
        if m == 0:
            return
        types.append(np.full(m, prim.type, dtype=np.int32))
        positions.append(pts)
        velocities.append(np.tile(np.asarray(prim.velocity, dtype=np.float64), (m, 1)))
        rigids.append(np.full(m, prim.rigid_type, dtype=np.int32))
        enthalpies.append(np.full(m, prim.enthalpy, dtype=np.float64))

    # primitives are emitted grouped by kind, in this fixed order
    # (generator.cpp:656-826), regardless of their order in the .boid file
    for kind in _PRIMITIVES:
        for prim in scene.primitives:
            if prim.kind != kind:
                continue
            if kind == "Cuboid":
                emit(prim, _lattice3(prim, (0.5, 0.5, 0.5)))
            elif kind == "Cuboid2":
                emit(prim, _lattice3(prim, (0.01, 0.01, 0.5)))
            elif kind == "Cyboid":
                pts = _lattice3(prim, (0.5, 0.5, 0.5))
                center = 0.5 * (np.asarray(prim.upper) + np.asarray(prim.lower))
                w0 = prim.upper[0] - prim.lower[0]
                r2 = np.sum((pts - center) ** 2, axis=1)
                outer2 = 0.25 * w0 * w0
                inner2 = outer2 * prim.ratio * prim.ratio
                emit(prim, pts[(r2 > inner2) & (r2 <= outer2)])
            elif kind == "Cyboid2":
                pts = _lattice3(prim, (0.01, 0.01, 0.5))
                center = 0.5 * (np.asarray(prim.upper) + np.asarray(prim.lower))
                w0 = prim.upper[0] - prim.lower[0]
                w1 = prim.upper[1] - prim.lower[1]
                x = pts[:, 0] - center[0]
                y = pts[:, 1] - center[1]
                r2 = x * x + y * y
                # note the reference's (0.5^4 w0^2 w1^2) outer and ratio^4
                # inner bounds (generator.cpp:752)
                outer = 0.0625 * w0 * w0 * w1 * w1
                inner = outer * prim.ratio ** 4
                emit(prim, pts[(r2 <= outer) & (r2 > inner)])
            elif kind == "Recboid":
                pts = _lattice3(prim, (0.01, 0.01, 0.5))
                # wedge keep-test tan(angle) > y/x (generator.cpp:784)
                t = math.tan(prim.angle * 3.1415 / 180.0)
                with np.errstate(divide="ignore", invalid="ignore"):
                    keep = t > pts[:, 1] / pts[:, 0]
                emit(prim, pts[keep])
            elif kind == "Recboid2":
                pts = _lattice3(prim, (0.01, 0.01, 0.5))
                th = prim.angle * 3.1415 / 180.0
                c, s = math.cos(th), math.sin(th)
                x = pts[:, 0] * c - pts[:, 1] * s
                y = pts[:, 0] * s + pts[:, 1] * c
                emit(prim, np.stack([x, y, pts[:, 2]], axis=1))

    if not types:
        z = np.zeros((0,))
        return (np.zeros((0,), np.int32), z.reshape(0, 3) if False else np.zeros((0, 3)),
                np.zeros((0, 3)), np.zeros((0,), np.int32), z)
    return (
        np.concatenate(types),
        np.concatenate(positions),
        np.concatenate(velocities),
        np.concatenate(rigids),
        np.concatenate(enthalpies),
    )


def generate_grid(scene: BoidScene) -> GridData:
    prop, pos, vel, _rigid, _enthalpy = generate_particles(scene)
    return GridData(
        time=0.0,
        spacing=scene.particle_distance,
        domain_min=np.asarray(scene.lower_domain, dtype=np.float64),
        domain_max=np.asarray(scene.upper_domain, dtype=np.float64),
        prop=prop,
        position=pos,
        # the reference generator writes Position twice (quirk Q6)
        initial_position=pos.copy(),
        velocity=vel,
    )


def generate_case(case_path: str) -> GridData:
    """CLI contract of the reference generator: ``GeneratorForMph <case>``
    reads ``<case>.boid`` and writes ``<case>.grid`` (generator.cpp:116-126)."""
    scene = parse_boid_file(f"{case_path}.boid")
    grid = generate_grid(scene)
    write_grid_file(grid, f"{case_path}.grid", generator_style=True)
    return grid


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else argv
    case = argv[0] if argv else "sample"
    grid = generate_case(case)
    print(f"{grid.n} particles were generated")


if __name__ == "__main__":
    main()
