"""Reader/writer for the reference's key-value ``.data`` physics config.

Counterpart of ``particlemethod_fsi_tpu/io/data_file.py`` (``parse_data_file``,
``_parse_wall_row``, ``write_data_file``), into this package's own
:class:`CaseConfig`.  The parser is the same; the writer prints every number
with ``repr`` (the shortest text that reads back to the same float) where the
JAX package prints ``%g``, so that a config written here reads back equal
field by field.

Format contract follows ``readDataFile`` (``src/main.cpp:729-786``):
whitespace-separated key-value lines; ``#`` comments; 6-wide per-type property
rows; ``SurfaceTension`` maps its 4 values to type slots [0],[1],[4],[5] and
``YoungModulus``/``PoissonRatio`` to [2],[3],[4],[5] (quirk Q8,
src/main.cpp:756-758); ``Wall6``/``Wall7`` rows carry rigid-wall kinematics for
wall types 4/5 (src/main.cpp:766-767).  Unknown keys are accepted with a
warning, matching the reference's "Invalid line" log-and-skip behavior
(src/main.cpp:768-770) -- the shipped ``dam.data`` contains several such dead
keys (Cohesion, Wall2, ...).
"""

from __future__ import annotations

import logging
from typing import Union

from particlemethod_fsi_tpu_torch.config import TYPE_COUNT, CaseConfig, WallMotion

logger = logging.getLogger(__name__)

# keys mapped to scalar CaseConfig fields
_SCALAR_KEYS = {
    "Dt": "dt",
    "ElasticDt": "elastic_dt",
    "OutputInterval": "output_interval",
    "VtkOutputInterval": "vtk_output_interval",
    "EndTime": "end_time",
    "RadiusRatioA": "radius_ratio_a",
    "RadiusRatioP": "radius_ratio_p",
    "RadiusRatioV": "radius_ratio_v",
}

# keys mapped to 6-wide per-type rows
_TABLE6_KEYS = {
    "Density": "density",
    "BulkModulus": "bulk_modulus",
    "BulkViscosity": "bulk_viscosity",
    "ShearViscosity": "shear_viscosity",
}

# 4-wide rows with type-slot mapping (quirk Q8)
_TABLE4_KEYS = {
    "SurfaceTension": ("surface_tension", (0, 1, 4, 5)),
    "YoungModulus": ("young_modulus", (2, 3, 4, 5)),
    "PoissonRatio": ("poisson_ratio", (2, 3, 4, 5)),
}

# Wall rows: the reference parses only Wall6/Wall7 -> wall types 4/5
# (src/main.cpp:766-767).  We accept Wall1..Wall8 -> types 0..5 clamped, but
# warn on the ones the reference would drop, for interop transparency.
_WALL_KEYS = {f"Wall{i}": i - 2 for i in range(1, 9)}
_REFERENCE_WALL_KEYS = {"Wall6", "Wall7"}


def parse_data_file(path_or_text: Union[str, "os.PathLike"], *, is_text: bool = False) -> CaseConfig:
    """Parse a ``.data`` file (or raw text with ``is_text=True``) into a
    :class:`CaseConfig` with default scene/numerics (set those separately)."""
    if is_text:
        text = str(path_or_text)
    else:
        with open(path_or_text) as f:
            text = f.read()

    updates: dict = {}
    interaction = [[1.0] * TYPE_COUNT for _ in range(TYPE_COUNT)]
    walls = [WallMotion() for _ in range(TYPE_COUNT)]
    table_updates: dict = {}

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        tokens = line.split()
        key = tokens[0]
        try:
            if key in _SCALAR_KEYS:
                updates[_SCALAR_KEYS[key]] = float(tokens[1])
            elif key in _TABLE6_KEYS:
                vals = [float(t) for t in tokens[1 : 1 + TYPE_COUNT]]
                if len(vals) != TYPE_COUNT:
                    raise ValueError(f"expected {TYPE_COUNT} values")
                table_updates[_TABLE6_KEYS[key]] = tuple(vals)
            elif key in _TABLE4_KEYS:
                field_name, slots = _TABLE4_KEYS[key]
                vals = [float(t) for t in tokens[1:5]]
                if len(vals) != 4:
                    raise ValueError("expected 4 values")
                row = list(table_updates.get(field_name, (0.0,) * TYPE_COUNT))
                for slot, v in zip(slots, vals):
                    row[slot] = v
                table_updates[field_name] = tuple(row)
            elif key.startswith("InteractionRatio(Type") and key.endswith(")"):
                t = int(key[len("InteractionRatio(Type") : -1])
                vals = [float(x) for x in tokens[1 : 1 + TYPE_COUNT]]
                if len(vals) != TYPE_COUNT:
                    raise ValueError(f"expected {TYPE_COUNT} values")
                interaction[t] = vals
            elif key == "Gravity":
                updates["gravity"] = tuple(float(t) for t in tokens[1:4])
            elif key in _WALL_KEYS:
                # "WallN Center x y z Velocity x y z Omega x y z"
                wall_type = _WALL_KEYS[key]
                vals = _parse_wall_row(tokens)
                if 0 <= wall_type < TYPE_COUNT:
                    walls[wall_type] = vals
                if key not in _REFERENCE_WALL_KEYS:
                    logger.warning(
                        "data key %r is ignored by the reference solver "
                        "(only Wall6/Wall7 are parsed); honoring it here", key
                    )
            else:
                logger.warning("Invalid line in data file %r", line)
        except (ValueError, IndexError) as e:
            logger.warning("Invalid line in data file %r (%s)", line, e)

    updates["interaction_ratio"] = tuple(tuple(r) for r in interaction)
    updates["walls"] = tuple(walls)
    updates.update(table_updates)
    return CaseConfig(**updates)


def _num(v) -> str:
    return repr(float(v))


def _parse_wall_row(tokens: list[str]) -> WallMotion:
    def grab(label: str) -> tuple[float, float, float]:
        i = tokens.index(label)
        return tuple(float(t) for t in tokens[i + 1 : i + 4])

    return WallMotion(center=grab("Center"), velocity=grab("Velocity"), omega=grab("Omega"))


def write_data_file(cfg: CaseConfig, path) -> None:
    """Emit a ``.data`` file readable by this package, the JAX package and
    the reference (numbers as ``repr``: they read back exactly)."""

    def row(name, vals, sep="\t"):
        return name + "\t" + sep.join(_num(v) for v in vals)

    def slots(vals, idx):
        return [vals[i] for i in idx]

    lines = ["#######"]
    for key, field_name in _SCALAR_KEYS.items():
        lines.append(row(key, [getattr(cfg, field_name)]))
    for key, field_name in _TABLE6_KEYS.items():
        lines.append(row(key, getattr(cfg, field_name)))
    for key, (field_name, idx) in _TABLE4_KEYS.items():
        lines.append(row(key, slots(getattr(cfg, field_name), idx)))
    for t in range(TYPE_COUNT):
        lines.append(row(f"InteractionRatio(Type{t})", cfg.interaction_ratio[t]))
    lines.append(row("Gravity", cfg.gravity, sep=" "))
    for t in (4, 5):
        w = cfg.walls[t]
        lines.append(
            f"Wall{t + 2}  " + "    ".join(
                label + " " + " ".join(_num(v) for v in vals)
                for label, vals in (("Center", w.center),
                                    ("Velocity", w.velocity),
                                    ("Omega", w.omega))))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
