"""PyTorch port vs JAX package: the ``packed`` candidate engine
(``ops/packed_engine``) on the same frame, float64 on the CPU.

Cases: ``mini_dam`` at rest, ``mini_fsi`` (coupled), the 3-D ``mini_dam_3d``,
a seeded jitter of ``mini_fsi`` with surface tension and an asymmetric
interaction-ratio table (every term of both phases live), and ``mini_fsi``
with structure particles at the positions of floor particles (pairs at
distance 0, which the JAX engines give the distance 1: kept).  Per case, one
JAX evaluation of each function is shared by the tests (eager JAX, no
compile).  Tolerance: rtol 1e-12 with atol 1e-13 of the row scale (the
scale of the terms each field sums, ``test_torch_common.field_scales``) --
the sums are taken in another order, nothing else differs; integers exact.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from cases import config_3d, dam_like_config, mini_dam, mini_dam_3d, mini_fsi
from test_torch_common import (
    F64,
    close_to_scale,
    field_scales,
    fields_np,
    jitter,
    port_packed_frame,
)
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu.config import SCENES
from particlemethod_fsi_tpu.ops import packed_engine as jpk
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu_torch import convert
from particlemethod_fsi_tpu_torch.ops import packed_engine as pk

CASES = ("mini_dam", "mini_fsi", "3d", "jitter", "coincident")
_IR = [[1.0] * 6 for _ in range(6)]
_IR[1][2] = 0.5
_IR[2][1] = 0.8
_COUPLED = dict(scene=SCENES["dam"],
                young_modulus=(0.0, 0.0, 1e3, 1e3, 1e8, 1e4))


def _coincident(grid):
    """``grid`` with a copy of each structure particle on the floor's top
    row at the position of the floor particle below it, as overlapping
    primitives generate (``cases/gate3d``: the gate stands in its floor)."""
    floor_top = (grid.prop == 4) & np.isclose(
        grid.position[:, 1], 2.5 * grid.spacing)
    x = grid.position[floor_top, 0]
    pick = np.nonzero(floor_top)[0][(x > 13.9e-3) & (x < 16.1e-3)]
    assert pick.size >= 2
    return dataclasses.replace(
        grid, prop=np.concatenate([grid.prop, np.full(pick.size, 2, np.int32)]),
        **{k: np.concatenate([getattr(grid, k), getattr(grid, k)[pick]])
           for k in ("position", "initial_position", "velocity")})


def _jax_sim(case):
    if case == "mini_dam":
        return JaxSimulation(dam_like_config(backend="packed"), mini_dam())
    if case == "3d":
        return JaxSimulation(config_3d(backend="packed"), jitter(mini_dam_3d(), 31))
    cfg = dam_like_config(backend="packed").replace(**_COUPLED)
    if case == "mini_fsi":
        return JaxSimulation(cfg, mini_fsi())
    if case == "coincident":
        # the JAX engines give a pair at one position the distance 1 (its
        # weights are then far from the kernel's), where the window sweeps
        # skip it: kept for parity
        return JaxSimulation(cfg, _coincident(mini_fsi()))
    cfg = cfg.replace(surface_tension=(0.05, 0.05, 0.05, 0.0, 0.05, 0.0),
                      interaction_ratio=tuple(tuple(r) for r in _IR))
    return JaxSimulation(cfg, jitter(mini_fsi(), 32))


def _noisy(fields: dict, seed: int) -> dict:
    """Sender fields that differ from the receivers' (seeded numpy noise of
    10 % on each), as an all-gather of other shards' fields would."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in ("pressure_p", "pressure_a", "gravity_center", "mu"):
        v = np.asarray(fields[k])
        out[k] = v * (1.0 + 0.1 * rng.standard_normal(v.shape))
    return out


@functools.lru_cache(maxsize=None)
def _case(case):
    """The JAX side of a case, once: its Simulation, sorted frame, phase-1
    fields, phase-2 forces of all receivers and of a receiver view with
    other sender fields, and the virial."""
    jsim = _jax_sim(case)
    s = jsim.state0
    grid, ks = jsim.cell_grid, jsim.kernels
    kw = dict(volume=jsim.volume, two_dimensional=jsim.cfg.two_dimensional,
              cap=jsim.cell_capacity)
    # eager: under jit XLA may take the cell divide another way, and a
    # particle on a cell boundary would change cells
    jf = jpk.sort_frame(s.pos, s.vel, s.prop, grid, with_cell_start=True)
    n = jf.pos.shape[0]
    start, count = n // 3, n // 3

    @jax.jit
    def phases(jf, tables, senders, mine):
        rv = jpk.receivers_of(jf)
        f1 = jpk.phase1_fields(jf, rv, grid, ks, tables, cap=kw["cap"])
        force = jpk.phase2_forces(jf, rv, f1, f1, grid, ks, tables, **kw)
        view = jpk.phase2_forces(jf, jpk.receivers_of(jf, start, count),
                                 senders, mine, grid, ks, tables, **kw)
        return f1, force, view, jpk.packed_virial(jf, f1, grid, ks, tables,
                                                  **kw)

    # the sender and receiver fields of the view come from phase 1's
    f1 = jax.jit(lambda jf, t: jpk.phase1_fields(
        jf, jpk.receivers_of(jf), grid, ks, t, cap=kw["cap"]))(jf, jsim.tables)
    senders = _noisy(f1, 7)
    mine = {k: np.asarray(f1[k])[start:start + count] for k in senders}
    f1, force, view_force, virial = phases(jf, jsim.tables, senders, mine)
    return dict(jsim=jsim, frame=jf, f1=f1, force=force, view=(start, count),
                senders=senders, mine=mine, view_force=view_force,
                virial=virial, kw=kw)


def _port(c):
    """(frame, grid, kernels, tables) of the case, as the port's objects."""
    jsim = c["jsim"]
    return (port_packed_frame(c["frame"]),
            convert.cell_grid_from_dict(dataclasses.asdict(jsim.cell_grid)),
            convert.kernel_set_from_dict(dataclasses.asdict(jsim.kernels)),
            convert.type_tables_from_numpy(fields_np(jsim.tables), dtype=F64))


def _t(fields):
    return {k: torch.tensor(np.asarray(v)) for k, v in fields.items()}


def _virial_scale(c):
    s = field_scales(c["jsim"], c["f1"])
    return (s["force"] * c["jsim"].cell_grid.support / c["jsim"].volume
            + float(np.abs(np.asarray(c["virial"][0])).max()))


@pytest.mark.parametrize("case", CASES)
def test_sort_frame_with_cell_start_matches_jax(case):
    c = _case(case)
    jsim, jf = c["jsim"], c["frame"]
    s = jsim.state0
    frame, grid, _, _ = _port(c)
    got = pk.sort_frame(torch.tensor(np.asarray(s.pos)),
                        torch.tensor(np.asarray(s.vel)),
                        torch.tensor(np.asarray(s.prop)), grid,
                        with_cell_start=True)
    for k in pk.SortedFrame._fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(jf, k)), err_msg=k)
    # the window sweeps' frame skips the search over every cell
    bare = pk.sort_frame(got.pos, got.vel, got.prop, grid)
    assert bare.cell_start is None and bare.coords is None


@pytest.mark.parametrize("case", CASES)
def test_phase1_fields_match_jax(case):
    c = _case(case)
    frame, grid, ks, tables = _port(c)
    f1 = pk.phase1_fields(frame, pk.receivers_of(frame), grid, ks, tables,
                          cap=c["kw"]["cap"])
    jf1 = c["f1"]
    assert set(f1) == set(jf1)
    scales = field_scales(c["jsim"], jf1)
    for k in ("density_a", "gravity_center", "vol_strain", "divergence",
              "pressure_p", "pressure_a", "mu"):
        close_to_scale(k, f1[k], jf1[k], scales.get(k))
    np.testing.assert_array_equal(f1["neighbor_count"].numpy(),
                                  np.asarray(jf1["neighbor_count"]))
    assert int(f1["cell_overflow"]) == int(jf1["cell_overflow"]) > 0
    assert int(f1["neighbor_count"].max()) >= 8
    if case == "jitter":
        for k in ("divergence", "pressure_a", "gravity_center"):
            assert float(np.abs(np.asarray(jf1[k])).max()) > 0, k
    if case == "coincident":
        # a weight at 1 m, 400 radii out: the sum is far past N0 (~6)
        assert float(np.asarray(jf1["vol_strain"]).max()) > 1e3


@pytest.mark.parametrize("case", CASES)
def test_phase2_forces_match_jax(case):
    """All receivers with their own fields, and the receiver view
    ``[n/3, 2n/3)`` with sender fields that differ from the receivers'."""
    c = _case(case)
    frame, grid, ks, tables = _port(c)
    kw = c["kw"]
    scale = field_scales(c["jsim"], c["f1"])["force"]
    f1 = _t(c["f1"])
    force = pk.phase2_forces(frame, pk.receivers_of(frame), f1, f1, grid, ks,
                             tables, **kw)
    close_to_scale("force", force, c["force"],
                   scale + float(np.abs(np.asarray(c["force"])).max()))
    start, count = c["view"]
    rv = pk.receivers_of(frame, start, count)
    assert int(rv.ids[0]) == start and rv.pos.shape[0] == count
    view = pk.phase2_forces(frame, rv, _t(c["senders"]), _t(c["mine"]), grid,
                            ks, tables, **kw)
    want = np.asarray(c["view_force"])
    close_to_scale("view force", view, want,
                   scale + float(np.abs(want).max()))
    # the other senders' fields changed the result
    other = np.asarray(c["force"])[start:start + count]
    assert np.abs(want - other).max() > 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("case", CASES)
def test_packed_virial_matches_jax(case):
    c = _case(case)
    frame, grid, ks, tables = _port(c)
    stress, vp = pk.packed_virial(frame, _t(c["f1"]), grid, ks, tables,
                                  **c["kw"])
    scale = _virial_scale(c)
    close_to_scale("virial", stress, c["virial"][0], scale)
    close_to_scale("virial pressure", vp, c["virial"][1], scale)
    assert float(np.abs(np.asarray(c["virial"][1])).max()) > 0


@pytest.mark.parametrize("case", CASES)
def test_receiver_blocks_equal_one_block(case, monkeypatch):
    """Receivers in blocks of 37 give, bit for bit, what one block gives."""
    c = _case(case)
    frame, grid, ks, tables = _port(c)
    kw = c["kw"]

    def run():
        force, f1 = pk.packed_fluid_forces(frame, grid, ks, tables, **kw)
        return (force, f1, *pk.packed_virial(frame, f1, grid, ks, tables,
                                             **kw))

    one = run()
    n = frame.pos.shape[0]
    assert pk.receiver_blocks(n, grid, kw["cap"]) == [(0, n)]
    monkeypatch.setattr(pk, "EDGES_PER_BLOCK",
                        37 * len(grid.offsets) * kw["cap"])
    assert len(pk.receiver_blocks(n, grid, kw["cap"])) == -(-n // 37)
    many = run()
    assert torch.equal(one[0], many[0])
    for k in one[1]:
        assert torch.equal(one[1][k], many[1][k]), k
    assert torch.equal(one[2], many[2]) and torch.equal(one[3], many[3])
    close_to_scale("force", one[0], c["force"], field_scales(
        c["jsim"], c["f1"])["force"] + float(np.abs(np.asarray(c["force"])).max()))


@pytest.mark.parametrize("case", ["mini_fsi", "3d"])
def test_apply_key_sort_and_resort_match_jax(case):
    c = _case(case)
    jf = c["frame"]
    frame = _port(c)[0]
    n = frame.pos.shape[0]
    rng = np.random.default_rng(5)
    keys = rng.integers(0, n // 4, size=n).astype(np.int32)  # with ties
    a1 = rng.standard_normal(n)
    a3 = rng.standard_normal((n, 3))
    want = jpk.apply_key_sort(keys, a1, a3)
    got = pk.apply_key_sort(torch.as_tensor(keys), torch.as_tensor(a1),
                            torch.as_tensor(a3))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jpk.resort(jf, a1, a3)
    got = pk.resort(frame, torch.as_tensor(a1), torch.as_tensor(a3))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # unsort undoes resort
    back = pk.unsort(frame, *got)
    np.testing.assert_array_equal(back[1].numpy(), a3)
