"""PyTorch port vs JAX package: the all-gather mode
(``parallel/sharding.py``), float64 on the CPU.

The port runs as 1, 2 and 4 gloo ranks (``parallel/launch.spawn``; each world
size is one spawn that drives both cases through ``launch.run_jobs``), the
JAX package's ``make_sharded_step`` on its virtual 8-device mesh at 2 and 4
devices.  Cases, from ``tests/test_multichip.py``: ``mini_dam`` for 5 steps
and ``mini_fsi`` coupled for 4.  Both run the packed engine, as there.

Tolerances are the JAX tests' own (``tests/test_multichip.py:37-38``):
positions within rtol 1e-12 and atol 1e-16, velocities within rtol 1e-10 and
atol 1e-15, slot for slot; against the JAX sharded step and against the
port's one-device ``packed`` step (the candidates of each rank's receivers
are padded to the widest over the ranks, so the sums are one device's)."""

import numpy as np
import pytest

from cases import dam_like_config, mini_dam, mini_fsi
from test_torch_common import port_cfg, port_grid
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)

from particlemethod_fsi_tpu.config import SCENES
from particlemethod_fsi_tpu.parallel import make_mesh, make_sharded_step, shard_state
from particlemethod_fsi_tpu.solver import Simulation as JaxSimulation
from particlemethod_fsi_tpu.state import to_numpy as jax_to_numpy
from particlemethod_fsi_tpu_torch.parallel import launch
from particlemethod_fsi_tpu_torch.parallel.comm import Comm
from particlemethod_fsi_tpu_torch.parallel import sharding
from particlemethod_fsi_tpu_torch.solver import Simulation
from particlemethod_fsi_tpu_torch.state import to_numpy

WORLDS = (1, 2, 4)
JAX_WORLDS = (2, 4)


def _dam_cfg():
    return dam_like_config(backend="packed")


def _fsi_cfg():
    return _dam_cfg().replace(
        scene=SCENES["dam"], young_modulus=(0.0, 0.0, 1e3, 1e3, 1e8, 1e4))


CASES = {"mini_dam": (_dam_cfg, mini_dam, 5),
         "mini_fsi": (_fsi_cfg, mini_fsi, 4)}


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for name, (make_cfg, make_grid, steps) in CASES.items():
        grid = make_grid()
        sim = JaxSimulation(make_cfg(), grid)
        for ndev in JAX_WORLDS:
            mesh = make_mesh(ndev)
            step = make_sharded_step(sim, mesh)
            state = shard_state(sim.state0, mesh)
            for _ in range(steps):
                state = step(state)
            out[name, ndev] = jax_to_numpy(state, grid.n)
    return out


@pytest.fixture(scope="module")
def one_device():
    """The port's one-device ``packed`` trajectory of each case."""
    out = {}
    for name, (make_cfg, make_grid, steps) in CASES.items():
        grid = make_grid()
        sim = Simulation(port_cfg(make_cfg()), port_grid(grid), device="cpu")
        out[name] = to_numpy(sim.run_chunk(sim.state0, steps), grid.n)
    return out


@pytest.fixture(scope="module")
def port_runs():
    jobs = [dict(mode="allgather", cfg=port_cfg(make_cfg()),
                 grid=port_grid(make_grid()),
                 script=[("run", steps), ("gather",)])
            for make_cfg, make_grid, steps in CASES.values()]
    out = {}
    for world in WORLDS:
        ranks = launch.spawn(launch.run_jobs, world, jobs, transport="gloo",
                             timeout=110.0, threads=1)
        for i, name in enumerate(CASES):
            out[name, world] = [r["jobs"][i][-1]["state"] for r in ranks]
    return out


def _close(got, want):
    np.testing.assert_array_equal(got["prop"], want["prop"])
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=1e-12,
                               atol=1e-16)
    np.testing.assert_allclose(got["vel"], want["vel"], rtol=1e-10,
                               atol=1e-15)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_allgather_matches_one_device_and_jax(port_runs, jax_runs,
                                              one_device, case, world):
    ranks = port_runs[case, world]
    got = ranks[0]
    _close(got, one_device[case])
    if world in JAX_WORLDS:
        _close(got, jax_runs[case, world])
    for other in ranks[1:]:  # every rank gathers the same state
        for k in ("prop", "pos", "vel"):
            np.testing.assert_array_equal(other[k], got[k])
    assert float(np.abs(got["vel"]).max()) > 0.0  # the scene moved


def test_shard_and_gather_round_trip_in_one_process():
    """At one rank the all-gather mode needs no process group: shard,
    step and gather on ``Comm.local``, equal to the one-device step."""
    grid = mini_dam()
    sim = Simulation(port_cfg(_dam_cfg()), port_grid(grid), device="cpu")
    comm = Comm.local("cpu")
    assert sharding.make_mesh(comm) == (1,)
    step = sharding.make_sharded_step(sim, comm)
    state = sharding.shard_state(sim, comm, sim.state0)
    state = sharding.gather_state(comm, step(state))
    want = to_numpy(sim.step(sim.state0), grid.n)
    _close(to_numpy(state, grid.n), want)
    with pytest.raises(ValueError, match="not divisible"):
        sharding.make_sharded_step(sim, Comm(0, 3, "cpu", "gloo"))


@pytest.mark.parametrize("transport", ["nccl", "gloo-host"])
def test_a_cuda_transport_without_cards_raises_before_any_rank(
        monkeypatch, transport):
    """The transport sets the ranks' device (``nccl`` and ``gloo-host``
    the card, ``gloo`` the CPU): a CUDA transport with no card visible
    raises in the caller, and no rank falls back to the CPU."""
    monkeypatch.setattr(launch.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA devices, 0 visible"):
        launch.spawn(launch.run_jobs, 2, [], transport=transport,
                     timeout=30.0)
