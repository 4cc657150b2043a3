"""The ring runs that the window kernels walk (phase 1, kernels 1 and 4,
``csrc/phase1_sweep.cu``; phase 2, kernels 2 and 5, ``csrc/phase2_sweep.cu``;
the virial, kernels 3 and 6, ``csrc/virial_sweep.cu``).  The frame is
sorted by key, so for one receiver
and one row offset the senders of its block's window that pass the pair
rule's ring test are one contiguous run of rows, found by two lower bounds
on the key: ``windows_t.ring_runs`` (key rule) and ``windows.ring_runs_rows``
(row rule) compute these runs as the kernels do.  On the scenes of
``tests/cases.py``, 2-D and 3-D, and on the frames the kernels meet -- fresh,
reused under the C8 margin (keys cached, positions moved; the key rule's
backend only, since the row-major backend sorts every step), the row-major
backend's own, and every pad moved into the fluid with every window run on
to the frame's end -- this file shows that

* the run is exactly the set of window senders that pass the ring test
  (the row rule's ``j != i`` aside: the receiver's own row lies in its run,
  and the kernel tests it);
* the plain phase-1, phase-2 and virial sweeps over the runs alone (one
  receiver a block, its run its window) equal the plain sweeps over the
  block windows in float64, rtol 1e-13 plus 1e-13 of the row's largest
  magnitude: the same terms, summed in another order (the neighbour count
  exactly; a planar frame's zero virial rows stay zero), also with a sender
  at exactly the kernel radius of a receiver, which phase 1's inclusive
  radius test takes and the virial's strict one, phase 2's, drops;
* every valid row's key is its ``cell_coords`` linear cell on a frame sorted
  from its positions, which is what makes the row rule's runs exact;
* the runs are shorter than the windows: what the redesign gains.
"""

import functools

import numpy as np
import pytest
import torch

from cases import dam_like_config, mini_fsi
from test_torch_common import WINDOW_KW, port_cfg, port_grid, port_statics
from test_torch_common import torch_one_thread  # noqa: F401 (autouse)
from test_torch_windows_rows import _case
from test_torch_windows_t import _jax_sim

from particlemethod_fsi_tpu.config import SCENES
from particlemethod_fsi_tpu_torch.ops import packed_engine as pk
from particlemethod_fsi_tpu_torch.ops import walls as wl
from particlemethod_fsi_tpu_torch.ops import windows as pw
from particlemethod_fsi_tpu_torch.ops import windows_t as pwt
from particlemethod_fsi_tpu_torch.solver import Simulation

_FSI = dict(scene=SCENES["dam"], young_modulus=(0.0, 0.0, 1e3, 1e3, 1e8, 1e4))


class Setup:
    """A frame with its window table and the statics of its sweeps."""

    def __init__(self, frame, grid, ks, tables, cfg, windows=None):
        self.frame, self.grid, self.ks = frame, grid, ks
        self.tables, self.cfg = tables, cfg
        self.windows = (windows if windows is not None
                        else pw.compute_windows(frame, grid, cfg))
        self.offs = pw.row_offsets(grid)[0]
        self.two_d = grid.cell_count[2] == 1


def _fresh(jsim, pos, vel, prop):
    grid, ks, tables, cfg = port_statics(jsim)
    as_t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    frame = pk.sort_frame(as_t(pos), as_t(vel), as_t(prop).to(torch.int32),
                          grid)
    return Setup(frame, grid, ks, tables, cfg)


def _port_sim(backend: str, margin: float):
    cfg = dam_like_config(**{**WINDOW_KW, "backend": backend,
                             "rebuild_margin": margin}).replace(**_FSI)
    return Simulation(port_cfg(cfg), port_grid(mini_fsi()), device="cpu")


@functools.lru_cache(maxsize=None)
def _setup(name: str) -> Setup:
    if name in ("mini_dam", "mini_fsi", "3d", "surface_tension"):
        jsim, (pos, vel, prop) = (_case if name.startswith("mini")
                                  else _jax_sim)(name)
        return _fresh(jsim, pos, vel, prop)
    if name == "c8_reused":
        # steps of the field-major backend under the C8 margin: the frame of
        # the last step holds the keys and windows of the last rebuild and
        # the positions of now
        sim = _port_sim("pallas_t", 0.5)
        state, cache = sim.state0, sim._init_cache(sim.state0)
        steps = 6
        with torch.no_grad():
            for _ in range(steps):
                state, cache = sim._step_core(state, cache)
        assert 1 <= cache["rebuilds"] < steps
        pos = wl.periodic_wrap(state.pos, sim._dmin_t, sim._width_t)
        orig = cache["orig"]
        valid = cache["prop_s"] >= 0
        assert bool((pos[orig] != cache["ref_pos"][orig])[valid].any())
        frame = pk.SortedFrame(key=cache["key"], pos=pos[orig],
                               vel=state.vel[orig], prop=cache["prop_s"],
                               orig=orig)
        return Setup(frame, sim._frame_grid, sim.kernels, sim.tables,
                     sim._pcfg, (cache["ws"], cache["wl"]))
    if name == "rows_backend":
        sim = _port_sim("pallas", 0.0)
        state = sim.run_chunk(sim.state0, 3)
        frame = pk.sort_frame(state.pos, state.vel, state.prop,
                              sim._frame_grid)
        return Setup(frame, sim._frame_grid, sim.kernels, sim.tables,
                     sim._pcfg)
    if name == "pads_in_fluid":
        # as chip_smoke.check_pads_in_windows: every pad next to a fluid
        # particle, every window on to the frame's end
        s = _setup("mini_fsi")
        f = s.frame
        pads = (f.prop < 0).nonzero()[:, 0]
        fluid = (f.prop == 1).nonzero()[:, 0][: pads.numel()]
        assert 8 <= pads.numel() <= fluid.numel()
        pos = f.pos.clone()
        pos[pads] = pos[fluid] + 0.3e-3 * torch.tensor(
            [1.0, 0.5, 0.0], dtype=pos.dtype)
        ws = s.windows[0]
        to_end = (f.pos.shape[0] - ws).to(torch.int32)
        return Setup(f._replace(pos=pos), s.grid, s.ks, s.tables, s.cfg,
                     (ws, to_end))
    raise ValueError(name)


FRAMES = ["mini_dam", "mini_fsi", "3d", "surface_tension", "c8_reused",
          "rows_backend", "pads_in_fluid"]
# the row rule runs on frames sorted from their positions only: the
# row-major backend never reuses a frame
RULE_FRAMES = [(f, r) for f in FRAMES for r in ("key", "rows")
               if (f, r) != ("c8_reused", "rows")]


def _runs(s: Setup, rule: str):
    if rule == "key":
        return pwt.ring_runs(s.frame, *s.windows, s.offs, s.cfg.block)
    return pw.ring_runs_rows(s.frame, *s.windows, s.grid, s.cfg.block)


@pytest.mark.parametrize("name,rule", RULE_FRAMES)
def test_run_is_exactly_the_ring(name, rule):
    s = _setup(name)
    lo, hi = _runs(s, rule)
    n_off = len(s.offs)
    assert lo.shape == hi.shape == (s.frame.pos.shape[0], n_off)
    ring = (pw.key_rule(s.frame, s.offs) if rule == "key"
            else pw.position_rule(s.frame, s.grid)).ring
    rows = torch.arange(s.frame.pos.shape[0])
    seen = 0
    for r0, r1, nb, o, idx, lane_valid in pw._window_slabs(
            s.frame, *s.windows, n_off, s.cfg.block):
        j = idx[:, None, :]
        in_run = ((j >= lo[r0:r1, o].view(nb, -1, 1))
                  & (j < hi[r0:r1, o].view(nb, -1, 1))
                  & lane_valid[:, None, :])
        passed = ring(r0, r1, nb, o, idx) & lane_valid[:, None, :]
        if rule == "rows":
            # the position rule holds j != i itself; the run keeps row i
            in_run = in_run & (j != rows[r0:r1].view(nb, -1, 1))
        assert torch.equal(in_run, passed), (name, rule, o, r0)
        seen += int(passed.sum())
    assert seen > 0
    # a run lies inside its block's window
    blk = rows // s.cfg.block
    ws = s.windows[0].long()[blk]
    assert bool(((lo >= ws) & (hi <= ws + s.windows[1].long()[blk])
                 & (lo <= hi)).all())


def _phase2_inputs(s: Setup, rule: str):
    n = s.frame.pos.shape[0]
    rng = np.random.default_rng(n)

    def seeded(scale, *shape):
        return torch.as_tensor(rng.normal(scale=scale, size=shape))

    mu = s.tables.shear_viscosity[torch.clamp(s.frame.prop, 0, 5).long()]
    visc = pwt.inverse_viscosity(mu) if rule == "key" else mu
    return seeded(1e2, n), seeded(1e1, n), seeded(1e-3, n, 3), visc


@pytest.mark.parametrize("name,rule", RULE_FRAMES)
def test_phase2_over_the_runs_alone(name, rule):
    s = _setup(name)
    lo, hi = _runs(s, rule)
    pp, pa, gc, visc = _phase2_inputs(s, rule)
    kw = dict(volume=s.ks.spacing ** (2 if s.two_d else 3),
              two_dimensional=s.two_d)
    one = s.cfg._replace(block=1)
    runs = (lo.to(torch.int32).contiguous(),
            (hi - lo).to(torch.int32).contiguous())
    if rule == "key":
        want = pwt.phase2_sweep_plain(s.frame, pp, pa, gc, visc, *s.windows,
                                      s.offs, s.ks, s.cfg, s.tables, **kw)
        got = pwt.phase2_sweep_plain(s.frame, pp, pa, gc, visc, *runs,
                                     s.offs, s.ks, one, s.tables, **kw)
    else:
        want = pw.phase2_rows_sweep_plain(s.frame, pp, pa, gc, visc,
                                          *s.windows, s.grid, s.ks, s.cfg,
                                          s.tables, **kw)
        got = pw.phase2_rows_sweep_plain(s.frame, pp, pa, gc, visc, *runs,
                                         s.grid, s.ks, one, s.tables, **kw)
    for r in range(2 if s.cfg.planar else 3):
        scale = float(want[r].abs().max())
        assert scale > 0, (name, rule, r)
        torch.testing.assert_close(got[r], want[r], rtol=1e-13,
                                   atol=1e-13 * scale)


def _phase1_windows_and_runs(s: Setup, rule: str, runs, *, count: bool,
                             support: float = None):
    """The plain phase-1 sums over the block windows and over the runs as
    one-receiver windows."""
    one = s.cfg._replace(block=1)
    if rule == "key":
        kw = dict(support=s.grid.support if support is None else support,
                  count=count)
        return (pwt.phase1_sweep_plain(s.frame, *s.windows, s.offs, s.ks,
                                       s.cfg, s.tables, **kw),
                pwt.phase1_sweep_plain(s.frame, *runs, s.offs, s.ks, one,
                                       s.tables, **kw))
    return (pw.phase1_rows_sweep_plain(s.frame, *s.windows, s.grid, s.ks,
                                       s.cfg, s.tables),
            pw.phase1_rows_sweep_plain(s.frame, *runs, s.grid, s.ks, one,
                                       s.tables))


def _assert_phase1_equal(got, want, s: Setup, count: bool, what):
    live = [pw.P1_WP, pw.P1_DIV]
    if s.cfg.surface_tension:
        live += [pw.P1_DA, pw.P1_GX, pw.P1_GY] + (
            [] if s.cfg.planar else [pw.P1_GZ])
    for r in live:
        scale = float(want[r].abs().max())
        assert scale > 0, (what, r)
        torch.testing.assert_close(got[r], want[r], rtol=1e-13,
                                   atol=1e-13 * scale)
    for r in set(range(7)) - set(live) - {pw.P1_COUNT}:
        assert not bool(want[r].any()) and not bool(got[r].any()), (what, r)
    assert torch.equal(got[pw.P1_COUNT], want[pw.P1_COUNT]), what
    assert bool(want[pw.P1_COUNT].any()) == count, what


@pytest.mark.parametrize("name,rule", RULE_FRAMES)
def test_phase1_over_the_runs_alone(name, rule):
    s = _setup(name)
    lo, hi = _runs(s, rule)
    runs = (lo.to(torch.int32).contiguous(),
            (hi - lo).to(torch.int32).contiguous())
    # the row rule always counts; the key rule on request (every dump)
    for count in ((False, True) if rule == "key" else (True,)):
        want, got = _phase1_windows_and_runs(s, rule, runs, count=count)
        _assert_phase1_equal(got, want, s, count, (name, rule, count))


def _at_exactly(s: Setup, radius2: float, steps=(0, 1)):
    """The fresh ``mini_dam`` frame sorted again after one fluid particle is
    moved to exactly ``sqrt(radius2)`` from a fluid receiver, by the plain
    versions' own arithmetic (``dx*dx + dy*dy`` in float64 is ``radius2``
    bit for bit); returns for each of ``steps`` the new frame's Setup and
    the two rows, with that sender so many steps (the smallest that move
    rij2) farther out: 0 is exactly the radius, -1 one step inside."""
    f = s.frame
    fluid = (f.prop == 1).nonzero()[:, 0]
    i, j = int(fluid[len(fluid) // 2]), int(fluid[0])
    xi, yi = float(f.pos[i, 0]), float(f.pos[i, 1])
    r = float(np.sqrt(radius2))
    # dx near r, ulp by ulp, and a small dy whose square moves rij2 by a
    # few of its ulps
    found = next(((xj, yj) for k in range(400) for m in range(-8, 9)
                  for xj, yj in [(xi + r + m * np.spacing(xi + r),
                                  yi + k * 1e-12)]
                  if (xj - xi) * (xj - xi) + (yj - yi) * (yj - yi)
                  == radius2), None)
    assert found is not None
    out = []
    for step in steps:
        pos = f.pos.clone()
        pos[j, 0] = found[0] + step * 4 * np.spacing(found[0])
        pos[j, 1] = found[1]
        frame = pk.sort_frame(pos, f.vel, f.prop, s.grid)
        new = Setup(frame, s.grid, s.ks, s.tables, s.cfg)
        rows = (frame.orig == i).nonzero()[0, 0], (frame.orig == j).nonzero()[0, 0]
        out.append((new, rows))
    return out


@pytest.mark.parametrize("rule", ["key", "rows"])
def test_phase1_takes_a_sender_at_exactly_the_radius(rule):
    """Phase 1's radius tests are inclusive (``radius^2 - rij2 >= 0``, JAX
    ``pallas_windows_t.py``, ``pallas_pairwise.py``), unlike phase 2's: a
    sender at exactly the radius counts, and the runs alone give the
    windows' sums.  Key rule: the kernel radius, read through the count
    with the support set to it; row rule: the frame's support, its count's
    radius."""
    s = _setup("mini_dam")
    radius = s.ks.radius_p if rule == "key" else s.grid.support
    counts = []
    for new, (ri, rj) in _at_exactly(s, radius * radius):
        lo, hi = _runs(new, rule)
        runs = (lo.to(torch.int32).contiguous(),
                (hi - lo).to(torch.int32).contiguous())
        # the sender lies in the receiver's run
        assert any(int(lo[ri, o]) <= rj < int(hi[ri, o])
                   for o in range(len(new.offs)))
        want, got = _phase1_windows_and_runs(new, rule, runs, count=True,
                                             support=radius)
        _assert_phase1_equal(got, want, new, True, rule)
        counts.append(int(want[pw.P1_COUNT][ri]))
    # at exactly the radius the pair counts; one step farther out it does not
    assert counts[0] == counts[1] + 1


def _virial_windows_and_runs(s: Setup, rule: str, runs):
    """The plain virial sums over the block windows and over the runs as
    one-receiver windows, on the seeded phase-2 inputs."""
    pp, pa, gc, visc = _phase2_inputs(s, rule)
    kw = dict(volume=s.ks.spacing ** (2 if s.two_d else 3),
              two_dimensional=s.two_d)
    one = s.cfg._replace(block=1)
    if rule == "key":
        return (pwt.virial_sweep_plain(s.frame, pp, pa, gc, visc, *s.windows,
                                       s.offs, s.ks, s.cfg, s.tables, **kw),
                pwt.virial_sweep_plain(s.frame, pp, pa, gc, visc, *runs,
                                       s.offs, s.ks, one, s.tables, **kw))
    return (pw.virial_rows_sweep_plain(s.frame, pp, pa, gc, visc, *s.windows,
                                       s.grid, s.ks, s.cfg, s.tables, **kw),
            pw.virial_rows_sweep_plain(s.frame, pp, pa, gc, visc, *runs,
                                       s.grid, s.ks, one, s.tables, **kw))


def _assert_virial_equal(got, want, s: Setup, what):
    """Every live component (a planar frame's four in-plane ones, else all
    nine) within rtol 1e-13 plus 1e-13 of its largest magnitude; a planar
    frame's five others zero in both."""
    live = (0, 1, 3, 4) if s.cfg.planar else tuple(range(9))
    for r in range(9):
        if r in live:
            scale = float(want[r].abs().max())
            assert scale > 0, (what, r)
            torch.testing.assert_close(got[r], want[r], rtol=1e-13,
                                       atol=1e-13 * scale)
        else:
            assert not bool(want[r].any()) and not bool(got[r].any()), (
                what, r)


@pytest.mark.parametrize("name,rule", RULE_FRAMES)
def test_virial_over_the_runs_alone(name, rule):
    s = _setup(name)
    lo, hi = _runs(s, rule)
    runs = (lo.to(torch.int32).contiguous(),
            (hi - lo).to(torch.int32).contiguous())
    want, got = _virial_windows_and_runs(s, rule, runs)
    _assert_virial_equal(got, want, s, (name, rule))


@pytest.mark.parametrize("rule", ["key", "rows"])
def test_virial_drops_a_sender_at_exactly_the_radius(rule):
    """The virial's radius tests are strict (``radius^2 - rij2 > 0``, as
    phase 2's; JAX ``pallas_windows_t.py``, ``pallas_pairwise.py``), and
    the kernels' pre-test is ``rij2 < reach2``: a sender at exactly the
    kernel radius of a receiver adds nothing to its virial (the receiver's
    sums are bit for bit those with the sender one step farther out), one
    step inside it does, and in every case the runs alone give the
    windows' sums.  Both rules: uniform radii, so the reach is the kernel
    radius, inside the row rule's support."""
    s = _setup("mini_dam")
    radius2 = s.ks.radius_p * s.ks.radius_p
    assert s.cfg.uniform_radii and radius2 < s.grid.support ** 2
    sums = []
    for new, (ri, rj) in _at_exactly(s, radius2, steps=(-1, 0, 1)):
        lo, hi = _runs(new, rule)
        runs = (lo.to(torch.int32).contiguous(),
                (hi - lo).to(torch.int32).contiguous())
        # the sender lies in the receiver's run
        assert any(int(lo[ri, o]) <= rj < int(hi[ri, o])
                   for o in range(len(new.offs)))
        want, got = _virial_windows_and_runs(new, rule, runs)
        _assert_virial_equal(got, want, new, rule)
        d = new.frame.pos[rj] - new.frame.pos[ri]
        sums.append((float(d[0] * d[0] + d[1] * d[1]), want[:, ri], got[:, ri]))
    (inside2, w_in, g_in), (exact2, w_at, g_at), (out2, w_out, g_out) = sums
    assert inside2 < radius2 == exact2 < out2
    assert torch.equal(w_at, w_out) and torch.equal(g_at, g_out)
    assert not torch.equal(w_in, w_out) and not torch.equal(g_in, g_out)


@pytest.mark.parametrize("name", [f for f in FRAMES if f != "c8_reused"])
def test_valid_keys_are_linear_cells(name):
    """On a frame sorted from its positions the key of every valid row is
    its linear cell (the same true divide in ``cell_coords`` and in the
    kernels' ``fsi_cell``), so the row rule's ring, one range of linear
    cells, is one range of keys; pads carry ``num_cells``, in no ring."""
    s = _setup(name)
    f, grid = s.frame, s.grid
    nx, ny, _ = grid.cell_count
    c = pk.cell_coords(f.pos, grid).long()
    lin = c[:, 0] + nx * (c[:, 1] + ny * c[:, 2])
    valid = f.prop >= 0
    assert bool(valid.any()) and bool((~valid).any())
    assert torch.equal(f.key.long()[valid], lin[valid])
    assert bool((f.key[~valid] == grid.num_cells).all())
    assert bool((f.key[1:] >= f.key[:-1]).all())


@pytest.mark.parametrize("name,rule", RULE_FRAMES)
def test_runs_are_shorter_than_the_windows(name, rule):
    s = _setup(name)
    lo, hi = _runs(s, rule)
    per_receiver_window = float(s.windows[1].double().sum()) * s.cfg.block
    assert float((hi - lo).double().sum()) < per_receiver_window


def test_pads_in_the_fluid_lie_in_no_rows_run():
    """The pads moved into the fluid lie in the windows and in the position
    rings of real receivers, where the plain version's ``prop_j >= 0``
    rejects them; the kernel's key-based runs leave them out before any
    test."""
    s = _setup("pads_in_fluid")
    f = s.frame
    lo, hi = _runs(s, "rows")
    pads = (f.prop < 0).nonzero()[:, 0]
    # no run reaches a pad row: pads sort last, after every key of a ring
    assert int(hi.max()) <= int(pads.min())
    # yet a pad sits in the position ring of some real receiver
    c = pk.cell_coords(f.pos, s.grid).long()
    real = (f.prop >= 0).nonzero()[:, 0]
    near = ((c[pads][:, None, 0] - c[real][None, :, 0]).abs() <= 1) & (
        (c[pads][:, None, 1] - c[real][None, :, 1]).abs() <= 1)
    assert bool(near.any())
    # and every pad lies in the windows run on to the frame's end
    blk_ws = s.windows[0].long()
    assert bool((blk_ws <= int(pads.min())).all())
