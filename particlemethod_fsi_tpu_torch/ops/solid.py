"""Total-Lagrangian elastic solid pipeline.

Counterpart of ``particlemethod_fsi_tpu/ops/solid.py``.  Ported:
:class:`SolidStatic`, :func:`inverse_with_identity_fallback`,
:func:`build_solid_static`, :func:`deformation_gradient_subset`,
:func:`stvk_stress`, :func:`stress_velocity_kick`, :func:`substep_subset`,
:func:`run_substeps`.  ``subset_tensors_to_full`` (diagnostics) is not ported
yet.  Added here: :func:`substeps_subset` (the substep loop alone, for the
halo's replicated structure) and the hand-written substep kernel
(``csrc/solid_substep.cu``).

The functions above are the plain version.  :func:`run_substeps` and
:func:`substeps_subset` take it only for CPU tensors; for a CUDA tensor
each substep is one call of ``fsi_solid_substep`` (two launches, counted in
:data:`launch_counts`) or the call raises.  The kernel walks the valid
initial-neighbour slots of each row alone, from the compacted tables that
:func:`compact_neighbors` adds to :class:`SolidStatic` at set-up.

Re-implements the reference's solid op chain (``src/main.cpp``):
``calculateNormalizer`` (:2544-2653), ``calculateElasticDeformationVector``
(:2673-2754), ``calculateStress`` (:2756-2809), ``calculateStressForce``
(:2812-2890) in its scatter-free symmetric form, and
``updateElasticPosition`` (:1910-2082) with the double-position-update quirk
Q1.  All solid state lives in a compact subset index space of the structure
particles only (``s_idx`` maps subset -> global slot), so solid cost scales
with the structure count.

Two things differ from the JAX module, neither in the numbers:

* The 2x2 / 3x3 contractions (F = F_raw A^-1, C = F^T F, P = F S A^-1) are
  written as explicit elementwise products and sums, so no matrix-multiply
  path, and hence no TF32 path, can be taken on the card: E = (F^T F - I)/2
  is a difference of two O(1) numbers and F must be I at rest.
* Padding rows of ``s_idx`` point one past the last slot, as there.  JAX
  clamps such a gather and drops such a scatter; PyTorch does neither, so
  the gather uses ``gather_idx`` (the same indices clamped) and the scatter
  writes the ``n_struct`` valid rows only -- the same result.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from particlemethod_fsi_tpu_torch.config import TYPE_COUNT, SceneConfig
from particlemethod_fsi_tpu_torch.ops.neighbors import min_image
from particlemethod_fsi_tpu_torch.ops.smoothing import KernelSet


class SolidStatic(NamedTuple):
    """Reference-configuration quantities in compact structure-subset space,
    computed once at setup.  S = padded structure count, K0 = max initial
    neighbors, sd = spatial dim."""

    s_idx: torch.Tensor  # [S] int32 global slot per subset entry (n_pad on padding)
    s_valid: torch.Tensor  # [S] bool
    nbr0: torch.Tensor  # [S, K0] int64 SUBSET indices of initial neighbors
    mask0: torch.Tensor  # [S, K0]
    xij0: torch.Tensor  # [S, K0, sd] min-image initial separations
    wij0: torch.Tensor  # [S, K0] WLS weights w(|xij0|, RadiusP)
    normalizer: torch.Tensor  # [S, sd, sd] A^-1 (identity fallback)
    sub_pos0: torch.Tensor  # [S, 3] initial positions of subset entries
    inv_rho: torch.Tensor  # [S] 1/Density[prop]
    lam: torch.Tensor  # [S] Lame lambda
    mu: torch.Tensor  # [S] Lame mu
    clamp: torch.Tensor  # [S] bool Dirichlet-clamped
    count0_full: torch.Tensor  # [N] int32 initial neighbor counts (diagnostics)
    gather_idx: torch.Tensor  # [S] int64: s_idx clamped to the last slot
    # the valid slots of nbr0 / xij0 / wij0 moved to a prefix of each row,
    # in slot order, slot-major, Kc = the most valid slots of a row (>= 1);
    # read by the kernel only (compact_neighbors)
    nbr0_c: torch.Tensor  # [Kc, S] int32 (0 past a row's count)
    xij0_c: torch.Tensor  # [Kc, sd, S]
    wij0_c: torch.Tensor  # [Kc, S]
    count0_c: torch.Tensor  # [S] int32 valid initial neighbours a row
    n_struct: int  # valid rows = the first n_struct

    @property
    def s_pad(self) -> int:
        return self.s_idx.shape[0]


def inverse_with_identity_fallback(a: np.ndarray) -> np.ndarray:
    """Batched explicit 2x2 / cofactor 3x3 inverse with identity fallback on
    det == 0, matching calculateNormalizer (src/main.cpp:2590-2651).  Host
    numpy (setup only)."""
    sd = a.shape[-1]
    if sd == 2:
        det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        adj = np.stack(
            [
                np.stack([a[..., 1, 1], -a[..., 0, 1]], axis=-1),
                np.stack([-a[..., 1, 0], a[..., 0, 0]], axis=-1),
            ],
            axis=-2,
        )
    elif sd == 3:
        def cof(i1, j1, i2, j2):
            return a[..., i1, j1] * a[..., i2, j2] - a[..., i1, j2] * a[..., i2, j1]

        det = (
            a[..., 0, 0] * cof(1, 1, 2, 2)
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
        )
        rows = []
        # adjugate rows as written in the reference (:2631-2641)
        rows.append(np.stack([cof(1, 1, 2, 2), -cof(1, 0, 2, 2), cof(1, 0, 2, 1)], axis=-1))
        rows.append(np.stack([-cof(0, 1, 2, 2), cof(0, 0, 2, 2), -cof(0, 0, 2, 1)], axis=-1))
        rows.append(np.stack([cof(0, 1, 1, 2), -cof(0, 0, 1, 2), cof(0, 0, 1, 1)], axis=-1))
        adj = np.stack(rows, axis=-2)
    else:
        raise ValueError(f"unsupported spatial dim {sd}")
    ok = det != 0.0
    safe_det = np.where(ok, det, 1.0)
    inv = adj / safe_det[..., None, None]
    eye = np.eye(sd, dtype=a.dtype)
    return np.where(ok[..., None, None], inv, eye)


def compact_neighbors(nbr0, mask0, xij0, wij0):
    """Host numpy: each row's initial-neighbour slots, which ``mask0`` marks
    as a prefix of the row (``ValueError`` otherwise), cut to the longest
    row and laid out slot-major for the kernel.  Returns ``(nbr0_c [Kc, S]
    int32, xij0_c [Kc, sd, S], wij0_c [Kc, S], count0_c [S] int32)``; slots
    past a row's count hold 0."""
    mask0 = np.asarray(mask0, dtype=bool)
    count = mask0.sum(axis=1).astype(np.int32)
    if not np.array_equal(mask0, np.arange(mask0.shape[1]) < count[:, None]):
        raise ValueError("initial neighbours must be a prefix of each row")
    kc = max(1, int(count.max(initial=0)))
    keep = mask0[:, :kc]
    nbr = np.where(keep, np.asarray(nbr0)[:, :kc], 0)
    w = np.where(keep, np.asarray(wij0)[:, :kc], 0.0)
    xij = np.where(keep[..., None], np.asarray(xij0)[:, :kc], 0.0)
    return (nbr.T.astype(np.int32), xij.transpose(1, 2, 0), w.T, count)


def build_solid_static(
    pos0_host,
    prop_host,
    nbr0_idx,
    nbr0_mask,
    ks: KernelSet,
    cfg_tables,
    scene: SceneConfig,
    domain_width,
    *,
    spatial_dim: int,
    dtype: torch.dtype,
    device="cpu",
    pad_multiple: int = 128,
) -> SolidStatic:
    """Compact the global structure particles + their initial neighbor lists
    (``nbr0_idx`` / ``nbr0_mask``: ``[n_pad, K0]`` global slot indices and
    validity, host numpy) into subset space and precompute every static
    quantity, in float64: the ``[S, K0]`` separations and the moment
    matrices on ``device``, the rest host-side in numpy, with the host's
    bits either way; the subset-sized arrays end on ``device``.
    ``cfg_tables`` is the CaseConfig."""
    sd = spatial_dim
    prop_h = np.asarray(prop_host)
    pos0_h = np.asarray(pos0_host, dtype=np.float64)
    width = np.asarray(domain_width, dtype=np.float64)
    s_mask_h = (prop_h >= 2) & (prop_h < 4)
    s_idx_h = np.nonzero(s_mask_h)[0].astype(np.int32)
    n_s = int(s_idx_h.size)
    s_pad = max(pad_multiple, ((n_s + pad_multiple - 1) // pad_multiple) * pad_multiple)

    # global slot -> subset index map
    g2s = np.zeros(prop_h.shape[0], dtype=np.int32)
    g2s[s_idx_h] = np.arange(n_s, dtype=np.int32)

    # padding entries index one past the end (see module docstring)
    s_idx = np.full(s_pad, prop_h.shape[0], dtype=np.int32)
    s_idx[:n_s] = s_idx_h
    s_valid = np.zeros(s_pad, dtype=bool)
    s_valid[:n_s] = True

    idx0_h = np.asarray(nbr0_idx)[s_idx_h]  # [n_s, K0] global ids
    mask0_h = np.asarray(nbr0_mask)[s_idx_h].copy()
    # only structure-structure edges participate (src/main.cpp:1608)
    mask0_h &= s_mask_h[idx0_h]
    k0 = idx0_h.shape[1]
    nbr0_sub = np.zeros((s_pad, k0), dtype=np.int32)
    nbr0_sub[:n_s] = np.where(mask0_h, g2s[idx0_h], 0)
    mask0 = np.zeros((s_pad, k0), dtype=bool)
    mask0[:n_s] = mask0_h

    sub_pos0 = np.zeros((s_pad, 3), dtype=np.float64)
    sub_pos0[:n_s] = pos0_h[s_idx_h]

    # the [S, K0] separations, their squared lengths and the moment matrix
    # in float64 on the device, each step one correctly rounded operation
    # in the host's order, so the host's bits at a fraction of its time:
    # the squares summed as np.sum(..., axis=-1) sums them, the moment
    # matrix A = sum w x0 (x) x0 one slot at a time from zero, as
    # np.einsum("nk,nki,nkj->nij") sums it (calculateNormalizer,
    # src/main.cpp:2564-2651).  The square root stays numpy's: the CPU
    # build of torch's is not correctly rounded
    f64 = dict(dtype=torch.float64, device=device)
    pos0_t = torch.as_tensor(sub_pos0, **f64)
    mask0_t = torch.as_tensor(mask0, device=device)
    width_t = torch.as_tensor(width, **f64)
    dxy = (pos0_t[torch.as_tensor(nbr0_sub, device=device).long()]
           - pos0_t[:, None, :])
    dxy = dxy - width_t * torch.floor(dxy / width_t + 0.5)  # min-image
    xij0_t = torch.where(mask0_t[..., None], dxy, 0.0)[..., :sd]
    q = xij0_t * xij0_t
    r2 = q[..., 0] + q[..., 1]
    if sd == 3:
        r2 = r2 + q[..., 2]
    # the WLS weight uses only the in-plane components in 2-D
    # (weight(), src/main.cpp:273-287); z is zero here anyway
    wij0 = np.where(mask0, ks.weight(np.sqrt(r2.cpu().numpy()), ks.radius_p),
                    0.0)
    wij0_t = torch.as_tensor(wij0, **f64)
    a = torch.zeros((s_pad, sd, sd), **f64)
    for k in range(k0):
        a = a + ((wij0_t[:, k, None, None] * xij0_t[:, k, :, None])
                 * xij0_t[:, k, None, :])
    # its inverse with identity fallback on det == 0
    normalizer = inverse_with_identity_fallback(a.cpu().numpy())
    xij0 = xij0_t.cpu().numpy()

    density_t = np.asarray(cfg_tables.density, dtype=np.float64)
    young_t = np.asarray(cfg_tables.young_modulus, dtype=np.float64)
    poisson_t = np.asarray(cfg_tables.poisson_ratio, dtype=np.float64)
    gather_idx = np.minimum(s_idx, prop_h.shape[0] - 1)
    sub_prop = np.where(s_valid, prop_h[gather_idx], 0)
    sub_prop = np.clip(sub_prop, 0, TYPE_COUNT - 1)
    rho = density_t[sub_prop]
    inv_rho = np.where((rho > 0) & s_valid, 1.0 / np.where(rho > 0, rho, 1.0), 0.0)
    # Lame constants (calculateLamesconstant, src/main.cpp:2533-2539)
    e_mod = young_t[sub_prop]
    nu = poisson_t[sub_prop]
    lam = np.where(s_valid, e_mod * nu / ((1.0 + nu) * (1.0 - 2.0 * nu)), 0.0)
    mu = np.where(s_valid, e_mod / (2.0 * (1.0 + nu)), 0.0)

    if scene.has_clamp:
        x0 = sub_pos0[:, scene.clamp_axis]
        c = (x0 > scene.clamp_threshold) if scene.clamp_greater else (
            x0 < scene.clamp_threshold)
        if scene.clamp2_threshold is not None:
            c2 = (x0 > scene.clamp2_threshold) if scene.clamp2_greater else (
                x0 < scene.clamp2_threshold)
            c = c | c2
        clamp = s_valid & c
    else:
        clamp = np.zeros(s_pad, dtype=bool)

    count0_full = np.zeros(prop_h.shape[0], dtype=np.int32)
    count0_full[s_idx_h] = mask0[:n_s].sum(axis=1)

    # the slot-major tables come as transposed views: laid out in order on
    # the device, not by the host
    def f(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype).contiguous()

    def g(x, dt=None):
        return torch.as_tensor(x).to(device=device, dtype=dt).contiguous()

    nbr0_c, xij0_c, wij0_c, count0_c = compact_neighbors(
        nbr0_sub, mask0, xij0, wij0)
    return SolidStatic(
        s_idx=g(s_idx),
        s_valid=g(s_valid),
        nbr0=g(nbr0_sub, torch.int64),
        mask0=g(mask0),
        xij0=f(xij0),
        wij0=f(wij0),
        normalizer=f(normalizer),
        sub_pos0=f(sub_pos0),
        inv_rho=f(inv_rho),
        lam=f(lam),
        mu=f(mu),
        clamp=g(clamp),
        count0_full=g(count0_full),
        gather_idx=g(gather_idx, torch.int64),
        nbr0_c=g(nbr0_c),
        xij0_c=f(xij0_c),
        wij0_c=f(wij0_c),
        count0_c=g(count0_c),
        n_struct=n_s,
    )


def _matmul_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched [n, sd, sd] x [n, sd, sd] product as elementwise products and
    one sum: full working precision on any device (no TF32)."""
    return (a[:, :, :, None] * b[:, None, :, :]).sum(dim=2)


def deformation_gradient_subset(sub_pos, solid: SolidStatic, domain_width):
    """F = [sum w xij (x) xij0] A^-1 with xij = xij0 + (uj - ui),
    u = min-image(pos - pos0), all in subset space
    (calculateElasticDeformationVector, src/main.cpp:2700-2752)."""
    sd = solid.xij0.shape[-1]
    u = min_image(sub_pos - solid.sub_pos0, domain_width)[..., :sd]  # [S,sd]
    u_rows = u.T  # [sd, S]
    uj = u_rows[:, solid.nbr0]  # [sd, S, K0]
    w = solid.wij0  # pre-masked weights (zero on empty neighbor slots)
    cols = []
    for i in range(sd):
        xij_i = solid.xij0[..., i] + (uj[i] - u_rows[i][:, None])  # [S, K0]
        cols.append(torch.stack(
            [torch.sum(w * xij_i * solid.xij0[..., j], dim=1)
             for j in range(sd)], dim=1))
    f_raw = torch.stack(cols, dim=1)  # [S, sd, sd]
    return _matmul_small(f_raw, solid.normalizer)


def stvk_stress(f, lam, mu):
    """Green-Lagrange strain E = (F^T F - I)/2 and StVK 2nd PK stress
    S = 2 mu E + lambda tr(E) I (calculateStress, src/main.cpp:2768-2808)."""
    sd = f.shape[-1]
    eye = torch.eye(sd, dtype=f.dtype, device=f.device)
    c = (f[:, :, :, None] * f[:, :, None, :]).sum(dim=1)  # F^T F
    strain = 0.5 * (c - eye)
    tr = torch.diagonal(strain, dim1=-2, dim2=-1).sum(dim=-1)
    stress = 2.0 * mu[:, None, None] * strain + (lam * tr)[:, None, None] * eye
    return strain, stress


def stress_velocity_kick(f, stress, solid: SolidStatic, elastic_dt: float):
    """Velocity increment [S, sd] from internal elastic forces, in the
    scatter-free symmetric form (replaces the ``acc atomic`` action-reaction
    of calculateStressForce, src/main.cpp:2834-2888):

        P_i   = F_i S_i A_i^-1
        dv_i  = (dtE / rho_i) * sum_j w(xij0) (P_i + P_j) xij0
    """
    p_nom = _matmul_small(_matmul_small(f, stress), solid.normalizer)
    sd = p_nom.shape[-1]
    s_n = p_nom.shape[0]
    p_rows = p_nom.reshape(s_n, sd * sd).T  # [sd2, S]
    p_j = p_rows[:, solid.nbr0]  # [sd2, S, K0]
    p_sum = p_j + p_rows[:, :, None]
    kick_comps = []
    for a in range(sd):
        acc = torch.zeros_like(solid.wij0)  # [S, K0]
        for b in range(sd):
            acc = acc + p_sum[a * sd + b] * solid.xij0[..., b]
        acc = torch.where(solid.mask0, solid.wij0 * acc, torch.zeros_like(acc))
        kick_comps.append(torch.sum(acc, dim=1))
    kick = torch.stack(kick_comps, dim=1)  # [S, sd]
    return elastic_dt * solid.inv_rho[:, None] * kick


def substep_subset(sub_pos, sub_vel, solid: SolidStatic, domain_width,
                   elastic_dt: float, *, double_position_update: bool):
    """One elastic substep in subset space: F -> (E, S) -> velocity kick ->
    clamp + integrate (the inner loop of main(), src/main.cpp:655-663, and
    updateElasticPosition, :1910-2082 with quirk Q1: free particles advance
    their position twice per substep, :2045-2079)."""
    sd = solid.xij0.shape[-1]
    f = deformation_gradient_subset(sub_pos, solid, domain_width)
    strain, stress = stvk_stress(f, solid.lam, solid.mu)
    dv = stress_velocity_kick(f, stress, solid, elastic_dt)
    dv = torch.where(solid.s_valid[:, None], dv, torch.zeros_like(dv))
    sub_vel = torch.cat([sub_vel[:, :sd] + dv, sub_vel[:, sd:]], dim=1)

    factor = 2.0 if double_position_update else 1.0
    sub_vel = torch.where(solid.clamp[:, None], torch.zeros_like(sub_vel), sub_vel)
    moved = sub_pos + factor * elastic_dt * sub_vel
    sub_pos = torch.where(solid.clamp[:, None], solid.sub_pos0, moved)
    return sub_pos, sub_vel, strain, stress


# kernel launches (one a substep: fsi_solid_substep's two launches count
# once); the plain version never counts
launch_counts = {"solid_substep": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _substeps_cuda(pos_in, vel_in, pos_out, vel_out, solid: SolidStatic,
                   domain_width, elastic_dt: float, substeps: int, *,
                   double_position_update: bool, spans=None):
    """``substeps`` (>= 1) substeps through ``csrc/solid_substep.cu``: the
    first reads ``pos_in`` / ``vel_in``, every one writes ``pos_out`` /
    ``vel_out``, and each later one reads and updates them in place.
    Returns the outputs."""
    from particlemethod_fsi_tpu_torch.ops import cuda_loader

    dtype, dev = pos_in.dtype, pos_in.device
    s_pad, sd = solid.s_pad, solid.xij0.shape[-1]
    kc = solid.nbr0_c.shape[0]
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"solid substep: unsupported dtype {dtype}")
    width = torch.as_tensor(domain_width, dtype=dtype, device=dev)
    for name, t, shape, dt in (
        ("pos_in", pos_in, (s_pad, 3), dtype),
        ("vel_in", vel_in, (s_pad, 3), dtype),
        ("pos_out", pos_out, (s_pad, 3), dtype),
        ("vel_out", vel_out, (s_pad, 3), dtype),
        ("width", width, (3,), dtype),
        ("sub_pos0", solid.sub_pos0, (s_pad, 3), dtype),
        ("nbr0_c", solid.nbr0_c, (kc, s_pad), torch.int32),
        ("xij0_c", solid.xij0_c, (kc, sd, s_pad), dtype),
        ("wij0_c", solid.wij0_c, (kc, s_pad), dtype),
        ("count0_c", solid.count0_c, (s_pad,), torch.int32),
        ("normalizer", solid.normalizer, (s_pad, sd, sd), dtype),
        ("inv_rho", solid.inv_rho, (s_pad,), dtype),
        ("lam", solid.lam, (s_pad,), dtype),
        ("mu", solid.mu, (s_pad,), dtype),
        ("clamp", solid.clamp, (s_pad,), torch.bool),
        ("s_valid", solid.s_valid, (s_pad,), torch.bool),
    ):
        if (tuple(t.shape) != shape or t.dtype != dt or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"solid substep: {name} must be a contiguous {dt} tensor of "
                f"shape {shape} on {dev}; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}, contiguous={t.is_contiguous()}")
    lib = cuda_loader.load()
    p_buf = torch.empty((sd * sd, s_pad), dtype=dtype, device=dev)
    move_dt = (2.0 if double_position_update else 1.0) * elastic_dt
    # the pointers, read once: only the first substep reads other inputs
    src = (pos_in.data_ptr(), vel_in.data_ptr())
    out = (pos_out.data_ptr(), vel_out.data_ptr())
    tables = (p_buf.data_ptr(), solid.sub_pos0.data_ptr(), width.data_ptr(),
              solid.nbr0_c.data_ptr(), solid.xij0_c.data_ptr(),
              solid.wij0_c.data_ptr(), solid.count0_c.data_ptr(),
              solid.normalizer.data_ptr(), solid.inv_rho.data_ptr(),
              solid.lam.data_ptr(), solid.mu.data_ptr(),
              solid.clamp.data_ptr(), solid.s_valid.data_ptr(), s_pad, kc,
              float(elastic_dt), float(move_dt))
    is_double = int(dtype == torch.float64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(substeps):
            if spans is not None:
                spans.part("solid substep")
            err = lib.fsi_solid_substep(is_double, sd, *src, *out, *tables,
                                        stream)
            if err != 0:
                raise RuntimeError(
                    f"solid substep: launch refused (cudaGetLastError = "
                    f"{err}; -1 means the arguments are outside what the "
                    f"kernel takes)")
            launch_counts["solid_substep"] += 1
            src = out
    return pos_out, vel_out


def substeps_subset(sub_pos, sub_vel, solid: SolidStatic, domain_width,
                    elastic_dt: float, substeps: int, *,
                    double_position_update: bool, spans=None):
    """``substeps`` elastic substeps in subset space (``sub_pos`` /
    ``sub_vel``: ``[S, 3]``); returns new tensors, the inputs are left
    intact.  CUDA tensors go through the kernel, CPU tensors through
    :func:`substep_subset`; no substep (``substeps`` 0, as a data file whose
    ElasticDt exceeds twice its Dt gives) returns copies of the inputs.
    ``spans`` gets each substep as a part of its open section."""
    if substeps <= 0:
        return sub_pos.clone(), sub_vel.clone()
    if sub_pos.is_cuda:
        return _substeps_cuda(
            sub_pos, sub_vel, torch.empty_like(sub_pos),
            torch.empty_like(sub_vel), solid, domain_width, elastic_dt,
            substeps, double_position_update=double_position_update,
            spans=spans)
    for _ in range(substeps):
        if spans is not None:
            spans.part("solid substep")
        sub_pos, sub_vel, _, _ = substep_subset(
            sub_pos, sub_vel, solid, domain_width, elastic_dt,
            double_position_update=double_position_update,
        )
    return sub_pos, sub_vel


def run_substeps(pos, vel, solid: SolidStatic, domain_width, elastic_dt: float,
                 substeps: int, *, double_position_update: bool, spans=None):
    """Gather structure subset, run the substep loop, scatter back.  Returns
    new ``pos`` / ``vel`` tensors; the inputs are left intact.  ``spans``
    (the caller's ``utils.trace.Spans``) gets each substep as a part of its
    open section.  The loop is :func:`substeps_subset`: the kernel for a
    CUDA tensor, the plain functions for a CPU tensor."""
    sub_pos, sub_vel = substeps_subset(
        pos[solid.gather_idx], vel[solid.gather_idx], solid, domain_width,
        elastic_dt, substeps, double_position_update=double_position_update,
        spans=spans)
    n_s = solid.n_struct
    rows = solid.gather_idx[:n_s]
    pos = pos.index_copy(0, rows, sub_pos[:n_s])
    vel = vel.index_copy(0, rows, sub_vel[:n_s])
    return pos, vel
