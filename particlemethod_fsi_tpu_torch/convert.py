"""Carry the JAX package's objects across to the port.

No counterpart in the JAX package.  Every function takes numpy arrays and
plain dicts -- ``dataclasses.asdict`` of a ``CaseConfig``, ``KernelSet`` or
``CellGrid``; ``state.to_numpy``; the fields of a ``SolidStatic``,
``SortedFrame``, ``NeighborList``, ``TypeTables`` or ``PallasConfig`` as
numpy arrays
(``{k: np.asarray(v) for k, v in obj._asdict().items()}``) -- and returns the
port's object.  This module imports nothing of the JAX package, so the caller
(a test, or a script that holds both packages) does the unpacking on its side.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from particlemethod_fsi_tpu_torch.config import (
    CaseConfig,
    CompatFlags,
    NumericsConfig,
    RollingMotion,
    SceneConfig,
    WallMotion,
)
from particlemethod_fsi_tpu_torch.ops.fluid import TypeTables
from particlemethod_fsi_tpu_torch.ops.neighbors import CellGrid, NeighborList
from particlemethod_fsi_tpu_torch.ops.packed_engine import SortedFrame
from particlemethod_fsi_tpu_torch.ops.smoothing import KernelSet
from particlemethod_fsi_tpu_torch.ops.solid import SolidStatic, compact_neighbors
from particlemethod_fsi_tpu_torch.ops.windows import WindowConfig
from particlemethod_fsi_tpu_torch.state import ParticleState


def _tuples(x):
    """Nested lists -> nested tuples (``asdict`` keeps tuples, JSON does not)."""
    if isinstance(x, (list, tuple)):
        return tuple(_tuples(v) for v in x)
    return x


def _known(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return {k: _tuples(v) for k, v in d.items()}


def case_config_from_dict(d: dict) -> CaseConfig:
    """``dataclasses.asdict(jax_case_config)`` -> the port's CaseConfig."""
    d = dict(d)
    scene = dict(d.pop("scene"))
    rolling = scene.pop("rolling", None)
    scene_cfg = SceneConfig(
        **_known(SceneConfig, scene),
        rolling=None if rolling is None else RollingMotion(**rolling))
    walls = tuple(WallMotion(**_known(WallMotion, w)) for w in d.pop("walls"))
    compat = CompatFlags(**_known(CompatFlags, d.pop("compat")))
    numerics = NumericsConfig(**_known(NumericsConfig, d.pop("numerics")))
    return CaseConfig(**_known(CaseConfig, d), scene=scene_cfg, walls=walls,
                      compat=compat, numerics=numerics)


def kernel_set_from_dict(d: dict) -> KernelSet:
    """``dataclasses.asdict(jax_kernel_set)`` -> the port's KernelSet."""
    return KernelSet(**_known(KernelSet, d))


def cell_grid_from_dict(d: dict) -> CellGrid:
    """``dataclasses.asdict(jax_cell_grid)`` -> the port's CellGrid."""
    return CellGrid(**_known(CellGrid, d))


def window_config_from_dict(d: dict) -> WindowConfig:
    """``jax_pallas_config._asdict()`` -> the port's WindowConfig."""
    return WindowConfig(**d)


def _as(a, dtype, device):
    return torch.as_tensor(np.array(a, order="C")).to(
        device=device, dtype=dtype)


def state_from_numpy(d: dict, *, dtype: torch.dtype, device="cpu") -> ParticleState:
    """``state.to_numpy(jax_state)`` (untrimmed: padded rows included, so
    that ``prop`` carries -1 on padding) -> the port's ParticleState."""
    return ParticleState(
        prop=_as(d["prop"], torch.int32, device),
        pos=_as(d["pos"], dtype, device),
        pos0=_as(d["pos0"], dtype, device),
        vel=_as(d["vel"], dtype, device),
        wall_center=_as(d["wall_center"], dtype, device),
        time=torch.tensor(float(d["time"]), dtype=dtype, device=device),
        ghost_overflow=torch.zeros((), dtype=torch.int32, device=device),
    )


def sorted_frame_from_numpy(d: dict, *, dtype: torch.dtype, device="cpu",
                            packed: bool = False) -> SortedFrame:
    """Fields of a JAX ``SortedFrame`` -> the port's SortedFrame.  A window
    frame's ``cell_start`` and ``coords`` are placeholders there and are
    dropped; ``packed=True`` carries them (a frame of ``sort_frame(...,
    with_cell_start=True)``, the packed engine's)."""
    frame = SortedFrame(
        key=_as(d["key"], torch.int32, device),
        pos=_as(d["pos"], dtype, device),
        vel=_as(d["vel"], dtype, device),
        prop=_as(d["prop"], torch.int32, device),
        orig=_as(d["orig"], torch.int64, device),
    )
    if not packed:
        return frame
    return frame._replace(cell_start=_as(d["cell_start"], torch.int64, device),
                          coords=_as(d["coords"], torch.int32, device))


def neighbor_list_from_numpy(d: dict, device="cpu") -> NeighborList:
    """Fields of a JAX ``NeighborList`` (``vars(nbr)``) -> the port's."""
    return NeighborList(
        idx=_as(d["idx"], torch.int64, device),
        mask=_as(d["mask"], torch.bool, device),
        count=_as(d["count"], torch.int32, device),
        cell_overflow=_as(d["cell_overflow"], torch.int32, device),
    )


def type_tables_from_numpy(d: dict, *, dtype: torch.dtype,
                           device="cpu") -> TypeTables:
    """Fields of a JAX ``TypeTables`` -> the port's (the float64 host copies
    the CUDA kernels take are made from the same arrays)."""
    names = ("density", "bulk_modulus", "bulk_viscosity", "shear_viscosity",
             "young_modulus", "poisson_ratio", "cof_a", "interaction_ratio")
    return TypeTables(
        **{k: _as(d[k], dtype, device) for k in names},
        interaction_ratio_host=tuple(
            float(v) for v in np.asarray(d["interaction_ratio"],
                                         dtype=np.float64).ravel()),
        cof_a_host=tuple(
            float(v) for v in np.asarray(d["cof_a"], dtype=np.float64)),
    )


def solid_static_from_numpy(d: dict, *, dtype: torch.dtype,
                            device="cpu") -> SolidStatic:
    """Fields of a JAX ``SolidStatic`` -> the port's, with the fields the
    port adds (clamped gather indices, the kernel's compacted neighbour
    tables, count of valid rows)."""
    s_idx = np.asarray(d["s_idx"])
    s_valid = np.asarray(d["s_valid"])
    n_full = int(np.asarray(d["count0_full"]).shape[0])
    n_s = int(s_valid.sum())
    if not s_valid[:n_s].all():
        raise ValueError("SolidStatic: valid rows must be a prefix")
    floats = ("xij0", "wij0", "normalizer", "sub_pos0", "inv_rho", "lam", "mu")
    nbr0_c, xij0_c, wij0_c, count0_c = compact_neighbors(
        d["nbr0"], d["mask0"], d["xij0"], d["wij0"])
    return SolidStatic(
        s_idx=_as(s_idx, torch.int32, device),
        s_valid=_as(s_valid, torch.bool, device),
        nbr0=_as(d["nbr0"], torch.int64, device),
        mask0=_as(d["mask0"], torch.bool, device),
        **{k: _as(d[k], dtype, device) for k in floats},
        clamp=_as(d["clamp"], torch.bool, device),
        count0_full=_as(d["count0_full"], torch.int32, device),
        gather_idx=_as(np.minimum(s_idx, n_full - 1), torch.int64, device),
        nbr0_c=_as(nbr0_c, torch.int32, device),
        xij0_c=_as(xij0_c, dtype, device),
        wij0_c=_as(wij0_c, dtype, device),
        count0_c=_as(count0_c, torch.int32, device),
        n_struct=n_s,
    )


def diagnostics_from_numpy(d: dict) -> dict:
    """A JAX ``Simulation.diagnostics`` dict -> plain numpy arrays under the
    same keys, as the port's ``Simulation.diagnostics`` returns them."""
    return {k: np.array(v) for k, v in d.items()}


def checkpoint_state_from_numpy(d: dict, *, dtype: torch.dtype,
                                device="cpu") -> ParticleState:
    """The arrays of a checkpoint ``.npz`` written by either package (as a
    dict of numpy arrays: ``dict(np.load(path))``) -> the port's
    ParticleState; what ``utils.checkpoint.load_checkpoint`` gives for the
    same file."""
    return state_from_numpy(
        {k: d[k] for k in ("prop", "pos", "pos0", "vel", "wall_center", "time")},
        dtype=dtype, device=device)


_REGION_FIELDS = ("prop", "pos", "pos0", "vel", "oid")
_REPLICATED_FIELDS = ("s_pos", "s_vel", "wall_center", "splits", "splits_y",
                      "time")


def halo_state_from_numpy(d: dict, rank: int, size: int, *,
                          dtype: torch.dtype, device="cpu"):
    """The fields of a JAX ``HaloState`` of a mesh of ``size`` devices (1-
    or 2-axis: block ``rank`` is the device ``ix * ny + iy``), as numpy
    arrays (``{k: np.asarray(getattr(state, k))}``) -> rank ``rank``'s port
    ``HaloState``: its block of the region rows and the replicated rest
    (``splits_y`` ``[nx, ny+1]``, one row of domain y bounds a column on a
    1-axis mesh)."""
    from particlemethod_fsi_tpu_torch.parallel.halo import HaloState

    cap = np.asarray(d["prop"]).shape[0] // size
    blk = slice(rank * cap, (rank + 1) * cap)
    ints = {"prop", "oid"}
    return HaloState(
        **{k: _as(np.asarray(d[k])[blk], torch.int32 if k in ints else dtype,
                  device) for k in _REGION_FIELDS},
        **{k: _as(d[k], dtype, device) for k in _REPLICATED_FIELDS})


def halo_state_to_numpy(states) -> dict:
    """Every rank's port ``HaloState``, in rank order -> the fields of the
    JAX ``HaloState`` as numpy arrays (region rows concatenated, the
    replicated fields from rank 0)."""
    out = {k: np.concatenate([getattr(s, k).cpu().numpy() for s in states])
           for k in _REGION_FIELDS}
    out.update({k: getattr(states[0], k).cpu().numpy()
                for k in _REPLICATED_FIELDS})
    return out
