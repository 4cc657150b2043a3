"""The plain reference of one time step, in plain PyTorch.

Frozen copy of the formulas of ``tests/oracle_numpy.py`` (``step``,
``initial_structure_neighbors``, ``normalizers``; commit 59262f8), which
transliterates the reference solver's step (``src/main.cpp:592-686``), with
the Turek-Hron inlet of ``src/main.cpp:419-438`` before the wrap, as the
port's step orders it.  The oracle is O(N^2); here the same sums run over a
neighbour list of the pairs within the radius plus a skin
(:mod:`fsibench.pairs`), each pair once and its terms added to both ends,
rebuilt whenever a particle has moved half the skin, so that it serves 1-2M
particles on the card.  Only what the benchmark's configurations use is
kept (see :mod:`fsibench.physics`): no surface tension, so the A and G
families and the diffuse interface are zero; uniform ratios and radii;
static walls.

``precision`` is the configuration's type: ``"float32"`` (what the
benchmark's configurations state: state, pair terms and sums in float32) or
``"float64"`` (the tests' CPU comparisons with the port's float64 path).
``precision="bfloat16"`` is the control, the step below float32: the state
and every sum in float32, each pair's terms (from its float32 separation on)
in bfloat16.  The solid stays in the state's type throughout.

Imports neither the port, nor ``jax``, nor the JAX package, and takes
nothing the port made: the scene's arrays and the configuration's numbers
are all it reads.
"""

from __future__ import annotations

import numpy as np
import torch

from fsibench.pairs import build_pairs, min_image, wrap
from fsibench.physics import Physics

# (the state's and every sum's type, each pair's terms' type)
PRECISIONS = {"float64": (torch.float64, torch.float64),
              "float32": (torch.float32, torch.float32),
              "bfloat16": (torch.float32, torch.bfloat16)}


# the neighbour list's skin, in spacings: rebuilt once a particle has moved
# half of it (a few times in a chunk of the benchmark's cells)
SKIN = 0.5
# pairs a block of the pair sums: bounds the float temporaries to ~1 GB
PAIR_BLOCK = 1 << 24


class Reference:
    """One scene's static set-up; :meth:`run` steps a state."""

    def __init__(self, phys: Physics, prop: np.ndarray, pos0: np.ndarray,
                 device, precision: str = "float32"):
        self.p = phys
        self.dev = torch.device(device)
        # the solid's 2x2 and 3x3 products in full float32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        self.dtype, self.pair_dtype = PRECISIONS[precision]
        self.skin = SKIN * phys.spacing
        d = phys.dim
        f = dict(dtype=self.dtype, device=self.dev)
        self.dmin = torch.as_tensor(phys.domain_min[:d], **f)
        self.width = torch.as_tensor(phys.domain_width[:d], **f)
        prop_t = torch.as_tensor(prop, dtype=torch.int64, device=self.dev)
        self.fluid = (prop_t >= 0) & (prop_t < 2)
        self.struct = (prop_t >= 2) & (prop_t < 4)
        self.moved = self.fluid | self.struct  # kicked by the fluid step

        def table(name):
            return torch.as_tensor(getattr(phys, name), **f)[prop_t]

        self.mass = table("density") * phys.volume
        self.kappa = table("bulk_modulus")
        self.lam = table("bulk_viscosity")
        self.mu = table("shear_viscosity")
        self.gravity = torch.as_tensor(phys.gravity[:d], **f)
        self._pairs = None
        self._pairs_at = None
        self.rebuilds = 0
        self._solid_setup(prop, np.asarray(pos0, dtype=np.float64))

    # -- the elastic solid (total Lagrangian, StVK), on its own rows -------
    def _solid_setup(self, prop, pos0):
        p, d = self.p, self.p.dim
        s_idx = np.nonzero((prop >= 2) & (prop < 4))[0]
        self.s_idx = torch.as_tensor(s_idx, dtype=torch.int64, device=self.dev)
        if s_idx.size == 0:
            return
        f = dict(dtype=self.dtype, device=self.dev)
        x0 = torch.as_tensor(pos0[s_idx, :d], dtype=torch.float64,
                             device=self.dev)
        a, b = build_pairs(x0, p.domain_min, p.domain_width,
                           p.structure_reach)
        # every pair both ways: receiver i, sender j
        i = torch.cat([a, b])
        j = torch.cat([b, a])
        xij0 = min_image(x0[j] - x0[i], self.width.double())
        r0 = torch.sqrt((xij0 * xij0).sum(dim=1))
        # the weight of radius P, not clipped at the radius (the oracle's)
        w0 = p.wnorm * (1.0 - r0 / p.radius) ** 2
        ns = s_idx.size
        amat = torch.zeros((ns, d, d), dtype=torch.float64, device=self.dev)
        amat.index_add_(0, i, w0[:, None, None] * xij0[:, :, None]
                        * xij0[:, None, :])
        det = torch.linalg.det(amat)
        eye = torch.eye(d, dtype=torch.float64, device=self.dev)
        safe = torch.where((det != 0)[:, None, None], amat, eye)
        norm = torch.where((det != 0)[:, None, None],
                           torch.linalg.inv(safe), eye)
        sprop = torch.as_tensor(prop[s_idx], dtype=torch.int64,
                                device=self.dev)
        e_mod = torch.as_tensor(p.young_modulus, **f)[sprop]
        nu = torch.as_tensor(p.poisson_ratio, **f)[sprop]
        self.s_i, self.s_j = i, j
        self.s_xij0 = xij0.to(self.dtype)
        self.s_w0 = w0.to(self.dtype)
        self.s_norm = norm.to(self.dtype)
        self.s_pos0 = torch.as_tensor(pos0[s_idx], **f)
        self.s_lam = e_mod * nu / ((1 + nu) * (1 - 2 * nu))
        self.s_mu = e_mod / (2 * (1 + nu))
        self.s_rho = torch.as_tensor(p.density, **f)[sprop]
        clamp = torch.zeros(ns, dtype=torch.bool, device=self.dev)
        if p.clamp is not None:
            axis, thr, greater = p.clamp
            x0a = self.s_pos0[:, axis]
            clamp = x0a > thr if greater else x0a < thr
        self.s_clamp = clamp

    def _substeps(self, pos, vel):
        p, d = self.p, self.p.dim
        sp, sv = pos[self.s_idx], vel[self.s_idx]
        i, j = self.s_i, self.s_j
        eye = torch.eye(d, dtype=self.dtype, device=self.dev)
        factor = 2.0 if p.double_substep else 1.0
        ns = sp.shape[0]
        for _ in range(p.substeps):
            u = min_image(sp[:, :d] - self.s_pos0[:, :d], self.width)
            xij = self.s_xij0 + (u[j] - u[i])
            fr = torch.zeros((ns, d, d), dtype=self.dtype, device=self.dev)
            fr.index_add_(0, i, self.s_w0[:, None, None] * xij[:, :, None]
                          * self.s_xij0[:, None, :])
            fmat = fr @ self.s_norm
            strain = 0.5 * (fmat.transpose(1, 2) @ fmat - eye)
            tr = strain.diagonal(dim1=1, dim2=2).sum(dim=1)
            stress = (2.0 * self.s_mu[:, None, None] * strain
                      + (self.s_lam * tr)[:, None, None] * eye)
            pk1 = fmat @ stress @ self.s_norm
            kick = torch.zeros((ns, d), dtype=self.dtype, device=self.dev)
            kick.index_add_(0, i, self.s_w0[:, None] * (
                (pk1[i] + pk1[j]) @ self.s_xij0[:, :, None])[:, :, 0])
            sv = sv.clone()
            sv[:, :d] += kick / self.s_rho[:, None] * p.elastic_dt
            sv = torch.where(self.s_clamp[:, None], torch.zeros_like(sv), sv)
            sp = torch.where(self.s_clamp[:, None], self.s_pos0,
                             sp + factor * sv * p.elastic_dt)
        pos, vel = pos.clone(), vel.clone()
        pos[self.s_idx] = sp
        vel[self.s_idx] = sv
        return pos, vel

    # -- the fluid step ----------------------------------------------------
    def _ensure_pairs(self, x):
        if self._pairs is not None:
            moved = min_image(x - self._pairs_at, self.width)
            if float((moved * moved).sum(dim=1).max()) < (0.5 * self.skin) ** 2:
                return
        a, b = build_pairs(x, self.p.domain_min, self.p.domain_width,
                           self.p.radius + self.skin)
        # sorted by the first row, kept as int32 until a block is used
        self._pairs = (a.to(torch.int32), b.to(torch.int32))
        self._pairs_at = x.clone()
        self.rebuilds += 1

    def _blocks(self):
        a_all, b_all = self._pairs
        for k in range(0, a_all.shape[0], PAIR_BLOCK):
            yield (a_all[k:k + PAIR_BLOCK].long(),
                   b_all[k:k + PAIR_BLOCK].long())

    def _geometry(self, x, v, a, b):
        """Per pair, in the pair type: the unit vector e (b - a), r, the
        radius mask, q = 1 - r / radius and u.e."""
        p = self.p
        d = min_image(x[b] - x[a], self.width).to(self.pair_dtype)
        r2 = (d * d).sum(dim=1)
        inside = (r2 < p.radius * p.radius) & (r2 > 0)
        r = torch.sqrt(torch.where(inside, r2, torch.ones_like(r2)))
        e = d / r[:, None]
        q = 1.0 - r / p.radius
        u = (v[b] - v[a]).to(self.pair_dtype)
        ude = (u * e).sum(dim=1)
        return e, r, inside, q, ude

    def forces(self, x, v):
        """Phase 1 + EOS, phase 2, the interface force and gravity: the
        force on every row ([N, dim], in the state's type)."""
        p = self.p
        n = x.shape[0]
        acc = self.dtype
        zero = torch.zeros((), dtype=self.pair_dtype, device=self.dev)
        wsum = torch.zeros(n, dtype=acc, device=self.dev)
        div = torch.zeros(n, dtype=acc, device=self.dev)
        dwc = p.wnorm * (-2.0 / p.radius)
        for a, b in self._blocks():
            e, r, inside, q, ude = self._geometry(x, v, a, b)
            w = torch.where(inside, p.wnorm * q * q, zero).to(acc)
            dv = torch.where(inside, -(ude * (dwc * q)), zero).to(acc)
            for rows in (a, b):
                wsum.index_add_(0, rows, w)
                div.index_add_(0, rows, dv)
        vol_strain = wsum - p.n0p
        # the EOS (src/main.cpp:2387-2392): no stiffness under tension
        pp = -self.lam * div + torch.where(
            vol_strain > 0.0, self.kappa * vol_strain,
            torch.zeros((), dtype=acc, device=self.dev))
        force = torch.zeros((n, p.dim), dtype=acc, device=self.dev)
        st = self.struct
        for a, b in self._blocks():
            e, r, inside, q, ude = self._geometry(x, v, a, b)
            dw = dwc * q
            fp = torch.where(inside, (pp[a] + pp[b]).to(self.pair_dtype)
                             * dw * p.volume, zero)
            mu_a, mu_b = self.mu[a], self.mu[b]
            musum = mu_a + mu_b
            mu_h = torch.where(musum > 0, 2.0 * mu_a * mu_b
                               / torch.where(musum > 0, musum,
                                             torch.ones_like(musum)),
                               torch.zeros_like(musum)).to(self.pair_dtype)
            fv = torch.where(inside, p.c_visc * mu_h * ude * (-dw) / r
                             * p.volume, zero)
            sa, sb = st[a], st[b]
            # a fluid or wall receiver takes pressure and viscosity; a
            # structure receiver takes pressure from non-structure senders
            # only (the interface force, src/main.cpp:2439-2472)
            ca = (torch.where(~sa | ~sb, fp, zero)
                  + torch.where(~sa, fv, zero))
            cb = (torch.where(~sb | ~sa, fp, zero)
                  + torch.where(~sb, fv, zero))
            force.index_add_(0, a, (ca[:, None] * e).to(acc))
            force.index_add_(0, b, -(cb[:, None] * e).to(acc))
        force = force + torch.where(self.moved[:, None],
                                    self.mass[:, None] * self.gravity,
                                    torch.zeros((), dtype=acc,
                                                device=self.dev))
        return force

    def _inlet(self, x, v, time: float):
        """The parabolic profile re-imposed on the fluid at the inlet, and
        downstream while the outlet holds it (src/main.cpp:419-438)."""
        c = self.p.inlet
        h = c["turek_ymax"] - c["turek_ymin"]
        uy = x[:, 1] - c["turek_ymin"]
        u_in = (1.5 * 4.0 * c["turek_umax"] / (h * h)) * uy * (h - uy)
        u_out = (4.0 * c["turek_umax"] / (h * h)) * uy * (h - uy)
        v = v.clone()
        inlet = self.fluid & (x[:, 0] <= 0.01)
        v[inlet] = 0.0
        v[inlet, 0] = u_in[inlet]
        if time < c["turek_outlet_until"]:
            outlet = self.fluid & (x[:, 0] > 1.5)
            v[outlet] = 0.0
            v[outlet, 0] = u_out[outlet]
        return v

    def step(self, pos, vel, time: float):
        """One step of ``[N, 3]`` positions and velocities at ``time``."""
        p, d = self.p, self.p.dim
        if p.inlet is not None:
            vel = self._inlet(pos, vel, time)
        pos = pos.clone()
        pos[:, :d] = wrap(pos[:, :d], self.dmin, self.width)
        x, v = pos[:, :d], vel[:, :d]
        self._ensure_pairs(x)
        force = self.forces(x, v)
        vel = vel.clone()
        kicked = v + force / self.mass[:, None] * p.dt
        vel[:, :d] = torch.where(self.moved[:, None], kicked, v)
        pos[:, :d] = torch.where(self.fluid[:, None],
                                 x + vel[:, :d] * p.dt, x)
        if self.s_idx.numel() and p.substeps > 0:
            pos, vel = self._substeps(pos, vel)
        return pos, vel

    @torch.no_grad()
    def run(self, pos, vel, time: float, steps: int):
        """``steps`` steps from ``pos``, ``vel`` (any float type, [N, 3]) at
        ``time``; returns the state's type."""
        pos = pos.to(self.dev, self.dtype)
        vel = vel.to(self.dev, self.dtype)
        for k in range(steps):
            pos, vel = self.step(pos, vel, time + k * self.p.dt)
        return pos, vel
