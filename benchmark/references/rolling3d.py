"""The plain reference of the rocking tank (``rolling3d-2m``): the frozen
reference's step (:mod:`fsibench.reference`, :mod:`fsibench.physics`)
with the reference solver's ``Rolling`` module in front of it.

At the start of each step, before the wrap (the order of the port's step
and of ``src/main.cpp:592-686``), every wall row is turned about z through
its type's wall centre (the ``Wall6``/``Wall7`` rows of the ``.data``
file) by the step's angle, taken as the reference computes it from two
sines (``src/main.cpp:2974-3019``):

    theta(t) = max_angle * sin(2 pi t / period)
    dtheta   = theta(t) - theta(t - dt)

and given the velocity of the rocking at ``t``, ``dtheta/dt(t) = max_angle
(2 pi / period) cos(2 pi t / period)``, times its turned lever arm, in the
plane (its z velocity zero).  The walls' centres stay where the file puts
them: their velocities are zero.  ``run`` takes the time of its first
step, so a chunk that starts later starts at its own angle.

Everything else (the pair sums, the one clamp, the elastic substeps, the
neighbour lists, the precisions) is the frozen reference's, unchanged.
:func:`physics` refuses by name what neither does: prescribed wall
velocities or spins (the ``Wall`` rows' general branch), and steps past
the time at which the reference solver stops moving its walls.

Plain PyTorch; imports nothing of the port and nothing of JAX.
"""

import dataclasses
import math

import torch

from fsibench import physics as frozen_physics
from fsibench import reference as frozen_reference

TYPE_COUNT = frozen_physics.TYPE_COUNT
WALL_TYPES = (4, 5)


@dataclasses.dataclass(frozen=True)
class Physics(frozen_physics.Physics):
    # each type's wall centre ([6][3]); the rocking's amplitude in radians
    # and its angular frequency, or None for walls at rest
    wall_center: tuple
    rolling: tuple | None
    # the time from which the reference solver's walls stand still
    wall_motion_end_time: float


def _wall_centres(walls) -> tuple:
    if walls == "static":
        return ((0.0, 0.0, 0.0),) * TYPE_COUNT
    if not isinstance(walls, list) or len(walls) != TYPE_COUNT:
        raise ValueError(f"walls: \"static\" or {TYPE_COUNT} wall motions")
    for t, w in enumerate(walls):
        for key in ("velocity", "omega"):
            if any(float(v) != 0.0 for v in w.get(key, (0.0, 0.0, 0.0))):
                raise ValueError(f"walls[{t}].{key}: the reference moves "
                                 "walls by the Rolling module only")
    return tuple(tuple(float(v) for v in w.get("center", (0.0, 0.0, 0.0)))
                 for w in walls)


def physics(cfg: dict, domain_min, domain_max) -> Physics:
    """The frozen constants of ``cfg`` and its rocking walls."""
    scene = dict(cfg["scene_physics"])
    rolling = scene.pop("rolling", None)
    centres = _wall_centres(cfg.get("walls", "static"))
    base = frozen_physics.physics(
        dict(cfg, walls="static", scene_physics=scene), domain_min,
        domain_max)
    rock = None
    if rolling is not None:
        rock = (float(rolling["max_angle_deg"]) * math.pi / 180.0,
                2.0 * math.pi / float(rolling["period"]))
    return Physics(**{f.name: getattr(base, f.name)
                      for f in dataclasses.fields(base)},
                   wall_center=centres, rolling=rock,
                   wall_motion_end_time=float(
                       scene.get("wall_motion_end_time", 0.2)))


class Reference(frozen_reference.Reference):
    """The frozen reference, its wall rows rocked at the start of each
    step."""

    def __init__(self, phys: Physics, prop, pos0, device,
                 precision: str = "float32"):
        # the solid's products and any matrix product in full float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(phys, prop, pos0, device, precision)
        prop_t = torch.as_tensor(prop, dtype=torch.int64, device=self.dev)
        wall = (prop_t >= WALL_TYPES[0]) & (prop_t <= WALL_TYPES[-1])
        self.w_idx = wall.nonzero().squeeze(1)
        centres = torch.as_tensor(phys.wall_center, dtype=self.dtype,
                                  device=self.dev)
        self.w_center = centres[prop_t[self.w_idx]]

    def _rock(self, pos, vel, time: float):
        """The walls turned by the step's angle and given the rocking's
        velocity at ``time``."""
        amp, freq = self.p.rolling
        dt = self.p.dt
        dtheta = amp * math.sin(freq * time) - amp * math.sin(
            freq * (time - dt))
        rate = amp * freq * math.cos(freq * time)
        c, s = math.cos(dtheta), math.sin(dtheta)
        r = pos[self.w_idx] - self.w_center
        x = c * r[:, 0] - s * r[:, 1]
        y = s * r[:, 0] + c * r[:, 1]
        pos, vel = pos.clone(), vel.clone()
        pos[self.w_idx] = torch.stack([x, y, r[:, 2]], dim=1) + self.w_center
        vel[self.w_idx] = torch.stack(
            [-rate * y, rate * x, torch.zeros_like(x)], dim=1)
        return pos, vel

    def step(self, pos, vel, time: float):
        if self.p.rolling is not None and self.w_idx.numel():
            pos, vel = self._rock(pos, vel, time)
        return super().step(pos, vel, time)

    @torch.no_grad()
    def run(self, pos, vel, time: float, steps: int):
        if (self.p.rolling is not None
                and time + (steps - 1) * self.p.dt
                >= self.p.wall_motion_end_time - 0.5 * self.p.dt):
            raise ValueError("wall_motion_end_time: the reference does not "
                             "stop the walls; its steps end before "
                             f"{self.p.wall_motion_end_time} s")
        return super().run(pos, vel, time, steps)
