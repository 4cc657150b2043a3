"""Window-sweep pair phases over the cell-sorted frame, with hand-written
CUDA kernels.

Counterpart of ``particlemethod_fsi_tpu/ops/pallas_windows_t.py``:

=============================  ==========================================
here                           there
=============================  ==========================================
``phase1_sweep`` (+ kernel)    ``_phase1_kernel`` via ``_sweep_t``
``phase1_fields_t``            ``phase1_fields_pallas_t`` (with EOS tail)
``phase2_sweep`` (+ kernel)    ``_phase2_kernel`` via ``_sweep_t``
``phase2_forces_t``            ``phase2_forces_pallas_t``
``inverse_viscosity``          the ``invmu`` lane of ``pack_phase2_t``
``virial_sweep`` (+ kernel)    ``_virial_kernel_t`` via ``_sweep_t``
``virial_t``                   ``virial_pallas_t``
=============================  ==========================================

What the TPU layout forced and this port drops: the field-major
``[W, N + wmax]`` packing (the kernels read the frame's own tensors, so
``pack_phase1_t`` has nothing left to do and ``pack_phase2_t`` shrinks to
:func:`inverse_viscosity`), window starts floored to 128 lanes, the poisoned
tail, keys as float lanes, window tables in 128-block chunks, the merged slab
and the double buffer.  What stays: the inputs (sorted frame, ``win_start`` /
``win_len`` ``[nblocks, n_off]``, the offsets of ``row_offsets``), the outputs
in sorted order, every mask and every formula.

Each sweep has three pieces in this module: the wrapper (``phase1_sweep``,
``phase2_sweep``, ``virial_sweep``), which launches the CUDA kernel for a
CUDA tensor -- or raises -- and takes the plain version only for a CPU
tensor; the plain PyTorch version (``*_plain``), which is what the CPU tests
run and what the kernel is held against on the card (the sweep bodies are
shared with the row-major family in :mod:`windows`, here with the key ring);
and a launch count in :data:`launch_counts` (one table for both families),
incremented where the kernel is launched and nowhere else.

Bound on an H100: by the roofline count (each input read once, each output
written once, against the pair math of the true neighbour pairs only) all
three sweeps are bound by bytes, some tens of bytes a particle.  The kernels
do not reach that bound.  Each walks only each receiver's ring run, a third
of its block's windows (:func:`ring_runs` computes the runs for the tests),
and spends its time staging those windows and pre-testing the run's
senders, some four times the neighbours.  See the notes in
``csrc/phase1_sweep.cu``, ``csrc/phase2_sweep.cu`` and
``csrc/virial_sweep.cu``; the measured times stand in ``PERF.md``.
"""

from __future__ import annotations

import torch

from particlemethod_fsi_tpu_torch.ops import cuda_loader
from particlemethod_fsi_tpu_torch.ops.fluid import TypeTables
from particlemethod_fsi_tpu_torch.ops.neighbors import CellGrid
from particlemethod_fsi_tpu_torch.ops.packed_engine import SortedFrame
from particlemethod_fsi_tpu_torch.ops.smoothing import KernelSet
from particlemethod_fsi_tpu_torch.ops.windows import (  # noqa: F401 (re-exported)
    P1_COUNT,
    P1_DA,
    P1_DIV,
    P1_GX,
    P1_GY,
    P1_GZ,
    P1_WP,
    WindowConfig,
    _c_doubles,
    _c_ints,
    _check_frame,
    _check_phase2_fields,
    _phase1_consts,
    _phase2_consts,
    _raise_on,
    clip_runs,
    compute_windows,
    eos_fields,
    key_rule,
    launch_counts,
    phase1_plain,
    phase2_plain,
    reset_launch_counts,
    row_offsets,
    virial_plain,
    virial_pressure,
)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase1_sweep_plain(frame: SortedFrame, win_start, win_len, offs,
                       ks: KernelSet, cfg: WindowConfig, tables: TypeTables,
                       *, support: float, count: bool = False):
    """Plain PyTorch version of the phase-1 sweep (the arithmetic of the JAX
    ``_phase1_kernel``): dense masked ``[blocks, B, W]`` pair blocks, a slab
    of receiver blocks at a time.  Returns ``[7, N]`` (rows ``P1_*``)."""
    return phase1_plain(frame, win_start, win_len, len(offs), ks, cfg,
                        tables, support=support, count=count,
                        rule=key_rule(frame, offs))


def _phase1_sweep_cuda(frame, win_start, win_len, offs, ks, cfg, tables,
                       support, count):
    _check_frame(frame, win_start, win_len, len(offs), cfg.block)
    n = frame.pos.shape[0]
    lib = cuda_loader.load()
    consts = _phase1_consts(ks, support)
    if len(consts) != lib.fsi_phase1_nconst():
        raise RuntimeError("phase1_sweep: constant table out of step with csrc")
    out = torch.empty((7, n), dtype=frame.pos.dtype, device=frame.pos.device)
    with_ratio = cfg.surface_tension and not cfg.uniform_ratio
    with torch.cuda.device(frame.pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fsi_phase1_sweep(
            int(frame.pos.dtype == torch.float64),
            frame.pos.data_ptr(), frame.vel.data_ptr(), frame.key.data_ptr(),
            frame.prop.data_ptr(), win_start.data_ptr(), win_len.data_ptr(),
            out.data_ptr(), n, cfg.block, len(offs), _c_ints(offs),
            _c_doubles(consts), _c_doubles(tables.interaction_ratio_host),
            int(cfg.planar), int(cfg.surface_tension), int(with_ratio),
            int(cfg.uniform_radii), int(count), stream)
    _raise_on(err, "phase1_sweep")
    launch_counts["phase1_sweep"] += 1
    return out


def phase1_sweep(frame: SortedFrame, win_start, win_len, offs, ks: KernelSet,
                 cfg: WindowConfig, tables: TypeTables, *, support: float,
                 count: bool = False):
    """Phase-1 sums per receiver, ``[7, N]`` in sorted order (rows ``P1_*``:
    density A, gravity-centre x y z, wp sum, divergence, neighbour count).

    A CUDA frame goes through the hand-written kernel
    (``csrc/phase1_sweep.cu``, replacing the TPU ``_phase1_kernel``) or the
    call raises; only a CPU frame takes :func:`phase1_sweep_plain`."""
    if frame.pos.is_cuda:
        return _phase1_sweep_cuda(frame, win_start, win_len, offs, ks, cfg,
                                  tables, support, count)
    return phase1_sweep_plain(frame, win_start, win_len, offs, ks, cfg,
                              tables, support=support, count=count)


def phase1_fields_t(frame: SortedFrame, grid: CellGrid, ks: KernelSet,
                    tables: TypeTables, *, cfg: WindowConfig, windows=None,
                    count: bool = False) -> dict:
    """Phase 1 (densities) + per-particle EOS; the output contract of the JAX
    ``phase1_fields_pallas_t`` without its ``window_overflow`` entry (the
    sweep walks windows of any length exactly)."""
    win_start, win_len = windows if windows is not None else compute_windows(
        frame, grid, cfg)
    offs, _ = row_offsets(grid)
    out = phase1_sweep(frame, win_start, win_len, offs, ks, cfg, tables,
                       support=grid.support, count=count)
    return eos_fields(out, frame, ks, tables)


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def inverse_viscosity(mu: torch.Tensor) -> torch.Tensor:
    """1/mu with mu = 0 -> inf, so that the harmonic mean
    ``2 / (1/mu_i + 1/mu_j)`` is exactly 0 when either side is inviscid (the
    ``invmu`` lane of the JAX ``pack_phase2_t``)."""
    pos = mu > 0
    return torch.where(pos, 1.0 / torch.where(pos, mu, torch.ones_like(mu)),
                       torch.full_like(mu, float("inf")))


def _mu_h_from_inverse(inv_i, inv_j):
    """Phase 2: ``2 / (1/mu_i + 1/mu_j)``, exactly 0 when either is inf."""
    return 2.0 / (inv_i + inv_j)


def _mu_h_from_inverse_guarded(inv_i, inv_j):
    """Virial: ``2 / (1/mu_i + 1/mu_j)`` where that sum is finite and
    positive, else 0."""
    inv_sum = inv_i + inv_j
    live = torch.isfinite(inv_sum) & (inv_sum > 0)
    return torch.where(
        live, 2.0 / torch.where(live, inv_sum, torch.ones_like(inv_sum)),
        torch.zeros_like(inv_sum))


def phase2_sweep_plain(frame: SortedFrame, pp, pa, gc, invmu, win_start,
                       win_len, offs, ks: KernelSet, cfg: WindowConfig,
                       tables: TypeTables, *, volume: float,
                       two_dimensional: bool):
    """Plain PyTorch version of the phase-2 sweep (the arithmetic of the JAX
    ``_phase2_kernel``).  ``gc`` is ``[N, 3]``; ``pa`` and ``gc`` are read
    with surface tension only.  Returns ``[3, N]``."""
    return phase2_plain(frame, pp, pa, gc, invmu, win_start, win_len,
                        len(offs), ks, cfg, tables, volume=volume,
                        two_dimensional=two_dimensional,
                        rule=key_rule(frame, offs), mu_h=_mu_h_from_inverse)


def _launch_t(name: str, rows: int, frame, pp, pa, gc, invmu, win_start,
              win_len, offs, ks, cfg, tables, volume, two_dimensional):
    """Launch ``fsi_phase2_sweep`` or ``fsi_virial_sweep`` (one argument
    list)."""
    _check_frame(frame, win_start, win_len, len(offs), cfg.block)
    _check_phase2_fields(frame, pp, pa, gc, invmu, cfg, "invmu")
    n = frame.pos.shape[0]
    dtype, dev = frame.pos.dtype, frame.pos.device
    lib = cuda_loader.load()
    consts = _phase2_consts(ks, volume, two_dimensional)
    if len(consts) != getattr(lib, f"fsi_{name.split('_')[0]}_nconst")():
        raise RuntimeError(f"{name}: constant table out of step with csrc")
    out = torch.empty((rows, n), dtype=dtype, device=dev)
    st = cfg.surface_tension
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"fsi_{name}")(
            int(dtype == torch.float64),
            frame.pos.data_ptr(), frame.vel.data_ptr(), frame.key.data_ptr(),
            frame.prop.data_ptr(), pp.data_ptr(),
            pa.data_ptr() if st else None, gc.data_ptr() if st else None,
            invmu.data_ptr(), win_start.data_ptr(), win_len.data_ptr(),
            out.data_ptr(), n, cfg.block, len(offs), _c_ints(offs),
            _c_doubles(consts), _c_doubles(tables.interaction_ratio_host),
            _c_doubles(tables.cof_a_host), int(cfg.planar), int(st),
            int(cfg.uniform_ratio), int(cfg.uniform_radii), stream)
    _raise_on(err, name)
    launch_counts[name] += 1
    return out


def phase2_sweep(frame: SortedFrame, pp, pa, gc, invmu, win_start, win_len,
                 offs, ks: KernelSet, cfg: WindowConfig, tables: TypeTables, *,
                 volume: float, two_dimensional: bool):
    """Pairwise force per receiver, ``[3, N]`` in sorted order.

    A CUDA frame goes through the hand-written kernel
    (``csrc/phase2_sweep.cu``, replacing the TPU ``_phase2_kernel``) or the
    call raises; only a CPU frame takes :func:`phase2_sweep_plain`."""
    if frame.pos.is_cuda:
        return _launch_t("phase2_sweep", 3, frame, pp, pa, gc, invmu,
                         win_start, win_len, offs, ks, cfg, tables, volume,
                         two_dimensional)
    return phase2_sweep_plain(frame, pp, pa, gc, invmu, win_start, win_len,
                              offs, ks, cfg, tables, volume=volume,
                              two_dimensional=two_dimensional)


def ring_runs(frame: SortedFrame, win_start, win_len, offs, block: int):
    """Each receiver's ring run per row offset under the key rule, as kernels
    1-3 (``fsi_phase1_sweep``, ``fsi_phase2_sweep``, ``fsi_virial_sweep``)
    find it: the senders whose key lies in
    ``key_i + off - 1 .. key_i + off + 1`` are one run of rows of the sorted
    frame.  Returns ``(lo, hi)`` int64 ``[N, n_off]``, clipped to the
    block's window.  Used by the tests and ``chip_smoke.py``; nothing on the
    main path calls it."""
    off = torch.as_tensor(offs, dtype=torch.long, device=frame.key.device)
    centre = frame.key.long()[:, None] + off
    return clip_runs(frame.key, centre - 1, centre + 1, win_start, win_len,
                     block)


def _phase2_inputs_t(fields: dict, cfg: WindowConfig):
    gc = fields["gravity_center"]
    if cfg.surface_tension:
        gc = gc.contiguous()
    return (fields["pressure_p"], fields["pressure_a"], gc,
            inverse_viscosity(fields["mu"]))


def phase2_forces_t(frame: SortedFrame, fields: dict, grid: CellGrid,
                    ks: KernelSet, tables: TypeTables, *, volume: float,
                    two_dimensional: bool, cfg: WindowConfig, windows=None):
    """Phase 2 (forces) over the full frame; ``[N, 3]`` in sorted order (the
    JAX ``phase2_forces_pallas_t``).  ``fields`` is the dict of
    :func:`phase1_fields_t`."""
    win_start, win_len = windows if windows is not None else compute_windows(
        frame, grid, cfg)
    offs, _ = row_offsets(grid)
    out = phase2_sweep(
        frame, *_phase2_inputs_t(fields, cfg), win_start, win_len, offs, ks,
        cfg, tables, volume=volume, two_dimensional=two_dimensional)
    return out.T


# ---------------------------------------------------------------------------
# virial (output-time diagnostics)
# ---------------------------------------------------------------------------


def virial_sweep_plain(frame: SortedFrame, pp, pa, gc, invmu, win_start,
                       win_len, offs, ks: KernelSet, cfg: WindowConfig,
                       tables: TypeTables, *, volume: float,
                       two_dimensional: bool):
    """Plain PyTorch version of the virial sweep (the arithmetic of the JAX
    ``_virial_kernel_t``): the force families with the receiver's pressure
    only and viscosity half-weighted, summed as ``f_a * xij_b``.  ``gc`` is
    ``[N, 3]``; ``pa`` and ``gc`` are read with surface tension only.
    Returns the raw sums ``[9, N]`` (component ``3 a + b``); a planar case
    leaves every row with a z index zero."""
    return virial_plain(frame, pp, pa, gc, invmu, win_start, win_len,
                        len(offs), ks, cfg, tables, volume=volume,
                        two_dimensional=two_dimensional,
                        rule=key_rule(frame, offs),
                        mu_h=_mu_h_from_inverse_guarded)


def virial_sweep(frame: SortedFrame, pp, pa, gc, invmu, win_start, win_len,
                 offs, ks: KernelSet, cfg: WindowConfig, tables: TypeTables, *,
                 volume: float, two_dimensional: bool):
    """Raw virial sums per receiver, ``[9, N]`` in sorted order.

    A CUDA frame goes through the hand-written kernel
    (``csrc/virial_sweep.cu``, replacing the TPU ``_virial_kernel_t``) or the
    call raises; only a CPU frame takes :func:`virial_sweep_plain`."""
    if frame.pos.is_cuda:
        return _launch_t("virial_sweep", 9, frame, pp, pa, gc, invmu,
                         win_start, win_len, offs, ks, cfg, tables, volume,
                         two_dimensional)
    return virial_sweep_plain(frame, pp, pa, gc, invmu, win_start, win_len,
                              offs, ks, cfg, tables, volume=volume,
                              two_dimensional=two_dimensional)


def virial_t(frame: SortedFrame, fields: dict, grid: CellGrid, ks: KernelSet,
             tables: TypeTables, *, volume: float, two_dimensional: bool,
             cfg: WindowConfig, windows=None):
    """Virial stress at every particle (the JAX ``virial_pallas_t``):
    ``(virial_stress [9, N] row-major components, virial_pressure [N])`` in
    sorted order.  ``fields`` is the dict of :func:`phase1_fields_t` for the
    same frame."""
    win_start, win_len = windows if windows is not None else compute_windows(
        frame, grid, cfg)
    offs, _ = row_offsets(grid)
    out = virial_sweep(
        frame, *_phase2_inputs_t(fields, cfg), win_start, win_len, offs, ks,
        cfg, tables, volume=volume, two_dimensional=two_dimensional)
    return virial_pressure(out, volume, two_dimensional)
