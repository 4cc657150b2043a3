"""Failure detection: NaN / blow-up watchdog with auto-recovery.

Counterpart of ``particlemethod_fsi_tpu/utils/watchdog.py``
(``sound_speed_bound``, ``check_state``).  The reference has no failure
handling beyond exit-on-failure allocation wrappers
(``src/errorfunc.cpp:8-31``); a diverging run produces NaN positions
silently.  Here the runner checks cheap invariants at every output boundary
and can roll back to the last good snapshot:

* finite positions/velocities,
* max speed below a CFL-style bound (c0-scaled).

:func:`check_state` takes numpy arrays or tensors on any device; the
reductions run where the data lies and only the verdict comes to the host.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class WatchdogReport:
    ok: bool
    reason: str = ""
    max_speed: float = 0.0


def sound_speed_bound(cfg) -> float:
    """Fastest acoustic speed over fluid/solid types: sqrt(K/rho) and
    sqrt(E/rho)."""
    best = 0.0
    for t in range(len(cfg.density)):
        rho = cfg.density[t]
        if rho <= 0:
            continue
        best = max(best, math.sqrt(cfg.bulk_modulus[t] / rho))
        if cfg.young_modulus[t] > 0:
            best = max(best, math.sqrt(cfg.young_modulus[t] / rho))
    return best if best > 0 else 1.0


def check_state(pos, vel, valid_mask, *, speed_limit: float) -> WatchdogReport:
    pos, vel, valid = (torch.as_tensor(a) for a in (pos, vel, valid_mask))
    valid = valid.to(pos.device)
    pos, vel = pos[valid], vel[valid]
    if not bool(torch.isfinite(pos).all()):
        return WatchdogReport(False, "non-finite positions")
    if not bool(torch.isfinite(vel).all()):
        return WatchdogReport(False, "non-finite velocities")
    max_speed = (float((vel * vel).sum(dim=1).sqrt().max())
                 if vel.numel() else 0.0)
    if max_speed > speed_limit:
        return WatchdogReport(
            False, f"max speed {max_speed:.3g} exceeds limit {speed_limit:.3g}",
            max_speed,
        )
    return WatchdogReport(True, "", max_speed)
