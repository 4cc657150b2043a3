"""Binary checkpoint/restore of the full simulation state.

Counterpart of ``particlemethod_fsi_tpu/utils/checkpoint.py``
(``save_checkpoint``, ``load_checkpoint``), with the same ``.npz`` layout and
format version: a checkpoint written by either package loads in the other.

The reference's restart contract is "any .prof is a valid .grid input"
(``writeProfFile`` emits the ``readGridFile`` format, ``src/main.cpp:957-982``
vs ``:788-904``) -- but that text snapshot drops the advected wall centers
and round-trips state through ``%e`` text.  This module adds an exact binary
checkpoint carrying every state array including wall centers, alongside the
``.prof`` path.
"""

from __future__ import annotations

import numpy as np
import torch

from particlemethod_fsi_tpu_torch.state import ParticleState

FORMAT_VERSION = 1


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_checkpoint(path, state: ParticleState, *, n: int, extra: dict | None = None):
    arrays = dict(
        version=np.int32(FORMAT_VERSION),
        n=np.int64(n),
        prop=_host(state.prop),
        pos=_host(state.pos),
        pos0=_host(state.pos0),
        vel=_host(state.vel),
        wall_center=_host(state.wall_center),
        time=np.float64(float(state.time)),
    )
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = _host(v)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path, *, dtype=None, device="cpu"):
    """Returns (ParticleState, n, extra).  ``dtype`` (a torch dtype) casts
    the float arrays; ``device`` is where the state is put."""
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")

        def cast(a):
            t = torch.as_tensor(np.array(a))
            return t.to(device=device, dtype=dtype if dtype else t.dtype)

        state = ParticleState(
            prop=torch.as_tensor(np.array(z["prop"], dtype=np.int32)).to(device),
            pos=cast(z["pos"]),
            pos0=cast(z["pos0"]),
            vel=cast(z["vel"]),
            wall_center=cast(z["wall_center"]),
            time=cast(z["time"]),
            ghost_overflow=torch.zeros((), dtype=torch.int32, device=device),
        )
        n = int(z["n"])
        extra = {
            k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")
        }
    return state, n, extra
