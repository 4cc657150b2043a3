"""``program.case_config``: what a configuration file states becomes the
port's ``CaseConfig``, the wall motion and the rocking walls included; the
shipped files give what they gave before; a key the port's classes do not
have is refused by name."""

import copy
import dataclasses
import json

import pytest

from fsibench import harness
from fsibench.program import case_config

CELLS = ["dam3d-2m.collapse", "turek-1m.channel"]


def _config(cell):
    return copy.deepcopy(harness.cell_spec(cell)["config"])


def _file_of(cfg) -> dict:
    """A port's CaseConfig as a configuration file states it (JSON: lists
    for tuples, ``scene_physics`` for its scene)."""
    d = json.loads(json.dumps(dataclasses.asdict(cfg)))
    d["scene_physics"] = d.pop("scene")
    return d


def _rocking_file() -> dict:
    """The rocking tank's walls and scene as a configuration file would
    state them: the floor's type 4 rocks about the tank's bottom centre."""
    static = {"center": [0.0, 0.0, 0.0], "velocity": [0.0, 0.0, 0.0],
              "omega": [0.0, 0.0, 0.0]}
    walls = [dict(static) for _ in range(6)]
    walls[4] = dict(static, center=[0.03, 0.0, 0.0])
    cfg = _config("dam3d-2m.collapse")
    cfg.update(walls=walls, scene_physics={
        "name": "rolling", "clamp_axis": 1, "clamp_threshold": 0.003,
        "rolling": {"max_angle_deg": 2.0, "period": 1.646}})
    return cfg


def test_rocking_walls_are_the_ports_rolling_tank():
    from particlemethod_fsi_tpu_torch.config import RollingMotion, WallMotion
    from particlemethod_fsi_tpu_torch.models import rolling_tank

    theirs, _ = rolling_tank()
    mine = case_config(_rocking_file())
    assert all(type(w) is WallMotion for w in mine.walls)
    assert mine.walls == theirs.walls
    for t, (a, b) in enumerate(zip(mine.walls, theirs.walls)):
        for f in dataclasses.fields(WallMotion):
            assert getattr(a, f.name) == getattr(b, f.name), (t, f.name)
    assert type(mine.scene.rolling) is RollingMotion
    assert mine.scene.rolling == theirs.scene.rolling
    assert mine.scene == theirs.scene


def _builders():
    from particlemethod_fsi_tpu_torch.models import (
        cantilever_bar, dam_break, dam_break_3d, dam_break_on_elastic_gate,
        hydroelastic_slab, rolling_tank, turek_config)

    return {
        "rolling_tank": lambda: rolling_tank()[0],
        "hydroelastic_slab": lambda: hydroelastic_slab()[0],
        "cantilever_bar": lambda: cantilever_bar()[0],
        "dam_break": lambda: dam_break(20)[0],
        "dam_break_on_elastic_gate": lambda: dam_break_on_elastic_gate(20)[0],
        "dam_break_3d": lambda: dam_break_3d(4)[0],
        "turek_config": lambda: turek_config(1e-3),
    }


@pytest.mark.parametrize("builder", ["rolling_tank", "hydroelastic_slab",
                                     "cantilever_bar", "dam_break",
                                     "dam_break_on_elastic_gate",
                                     "dam_break_3d", "turek_config"])
def test_every_field_the_file_states_reaches_the_port(builder):
    """Each of the port's case builders, written out as a file states it,
    comes back as the same CaseConfig: every field, nested classes, wall
    motion, rocking walls, the second clamp and the profiles included."""
    theirs = _builders()[builder]()
    file = _file_of(theirs)
    file.update(name="x", scene="x", sizes={}, assumed=["x"])
    assert case_config(file) == theirs
    f64 = case_config(file, "float64")
    assert f64 == theirs.replace(numerics=dataclasses.replace(
        theirs.numerics, dtype="float64"))


def _as_before(cfg: dict, dtype=None):
    """The adapter's CaseConfig before it carried wall motion (static walls
    only, the fields the shipped files state)."""
    from particlemethod_fsi_tpu_torch.config import (
        CaseConfig, CompatFlags, NumericsConfig, SceneConfig)

    numerics = dict(cfg["numerics"])
    if dtype is not None:
        numerics["dtype"] = dtype
    return CaseConfig(
        dt=cfg["dt"], elastic_dt=cfg["elastic_dt"],
        radius_ratio_a=cfg["radius_ratio_a"],
        radius_ratio_p=cfg["radius_ratio_p"],
        radius_ratio_v=cfg["radius_ratio_v"],
        density=tuple(cfg["density"]),
        bulk_modulus=tuple(cfg["bulk_modulus"]),
        bulk_viscosity=tuple(cfg["bulk_viscosity"]),
        shear_viscosity=tuple(cfg["shear_viscosity"]),
        surface_tension=tuple(cfg["surface_tension"]),
        young_modulus=tuple(cfg["young_modulus"]),
        poisson_ratio=tuple(cfg["poisson_ratio"]),
        interaction_ratio=tuple(tuple(r) for r in cfg["interaction_ratio"]),
        gravity=tuple(cfg["gravity"]),
        two_dimensional=cfg["two_dimensional"],
        scene=SceneConfig(**cfg["scene_physics"]),
        compat=dataclasses.replace(CompatFlags(), **cfg["compat"]),
        numerics=NumericsConfig(**numerics),
    )


@pytest.mark.parametrize("dtype", [None, "float64"])
@pytest.mark.parametrize("cell", CELLS)
def test_shipped_files_give_the_case_config_they_gave(cell, dtype):
    cfg = _config(cell)
    assert cfg["walls"] == "static"
    assert case_config(cfg, dtype) == _as_before(cfg, dtype)
    absent = dict(cfg)
    del absent["walls"]
    assert case_config(absent, dtype) == _as_before(cfg, dtype)


# (where, the key planted there)
UNKNOWN = [((), "dt_typo"), (("scene_physics",), "rolling_angle"),
           (("scene_physics", "rolling"), "amplitude"),
           (("compat",), "freeze_walls"), (("numerics",), "blocks"),
           (("walls", 4), "centre")]


@pytest.mark.parametrize("where,key", UNKNOWN)
def test_an_unknown_key_is_refused_by_name(where, key):
    cfg = _rocking_file()
    group = cfg
    for k in where:
        group = group[k]
    group[key] = 1.0
    with pytest.raises(ValueError, match=key):
        case_config(cfg)


@pytest.mark.parametrize("walls", ["rocking", [], [{}] * 5])
def test_walls_are_static_or_six_motions(walls):
    cfg = _config("dam3d-2m.collapse")
    cfg["walls"] = walls
    with pytest.raises(ValueError, match="walls"):
        case_config(cfg)
