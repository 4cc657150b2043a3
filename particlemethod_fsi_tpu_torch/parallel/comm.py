"""The collectives the multi-device layer uses, over a ``torch.distributed``
process group.

No module of the JAX package is its counterpart: there ``shard_map`` gives
each shard ``jax.lax.axis_index``, tiled ``all_gather``, ``ppermute`` over
the ring ``perm(+-1, n)`` of a mesh axis (``parallel/halo.py:715-717``),
``pmax`` and ``psum`` over every axis.  Here each shard is a process with
one device, and :class:`Comm` gives the same operations on that process's
tensors:

* :attr:`Comm.shape` -- the mesh ``(nx, ny)`` of the ranks: ``(size, 1)``
  for the 1-D ring, or a 2-axis grid (``sharding.make_mesh_grid``), where
  rank ``r`` sits at ``(r // ny, r % ny)`` (the JAX mesh's row-major block
  index ``ix * ny + iy``, ``halo.py:115-119``);
* :meth:`Comm.all_gather` -- the tiled all-gather (ranks' rows in rank
  order);
* :meth:`Comm.ring` -- one ``ppermute`` step of the ring along a mesh
  axis: every rank sends to the rank ``direction`` steps on along that
  axis and receives from the rank ``direction`` steps back (mod the axis
  size), the other coordinate fixed.  Along an axis of size 1 the rank
  sends to itself, which is a local copy (``batch_isend_irecv`` to a rank's
  own number raises); at size 2 both directions reach the one peer, and a
  call's one message each way keeps the pairs matched.  The peers are
  global ranks of the one process group: no sub-group is made;
* :meth:`Comm.max` and :meth:`Comm.sum` -- ``pmax`` and ``psum`` over
  every rank.

Several tensors of one collective travel as one message: they are packed
into one byte buffer (any dtypes; ``oid`` stays int32 end to end) and
unpacked on arrival.  Every rank calls every collective in the same order;
a rank that skipped one would hang the group, so callers decide a branch
that holds a collective from values every rank has (a :meth:`max` first).

Transports (:attr:`Comm.transport`): ``nccl`` for CUDA tensors, one card a
rank; ``gloo`` for CPU tensors; ``gloo-host``, CUDA tensors staged through
host memory, only so that several ranks can share one card (NCCL refuses
two ranks on one device and gloo sends no CUDA tensor; the command line
never picks it).  ``Comm.local(device)`` is a world of one rank with no
process group, for in-process use.
"""

from __future__ import annotations

import time as _time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

TRANSPORTS = ("nccl", "gloo", "gloo-host")


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a tensor takes in a packed buffer: a multiple of 8, so that
    every tensor starts aligned for any dtype."""
    return -(-t.numel() * t.element_size() // 8) * 8


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, one after another (each padded to 8 bytes), as
    one uint8 tensor."""
    parts = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        parts.append(torch.nn.functional.pad(b, (0, _nbytes(t) - b.numel())))
    return torch.cat(parts)


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> list:
    """Tensors shaped and typed as ``like`` from :func:`_pack`'s bytes."""
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[at:at + n].view(t.dtype).reshape(t.shape))
        at += _nbytes(t)
    return out


class Comm:
    """One rank's view of the mesh of ranks (``shape`` ``(nx, ny)``; a 1-D
    ring of ``size`` devices unless given).  ``seconds`` and ``calls`` add
    up the host time spent in the collectives and their number (with
    ``nccl`` the host returns before the device has finished, so there
    ``seconds`` counts enqueueing only)."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 transport: Optional[str], group=None,
                 shape: Optional[tuple] = None):
        if size > 1 and transport not in TRANSPORTS:
            raise ValueError(f"transport {transport!r}: not one of "
                             f"{TRANSPORTS}")
        shape = (size, 1) if shape is None else tuple(int(v) for v in shape)
        if len(shape) != 2 or shape[0] * shape[1] != size:
            raise ValueError(f"mesh shape {shape} does not hold {size} "
                             "ranks")
        self.rank = rank
        self.size = size
        self.shape = shape
        self.device = torch.device(device)
        self.transport = transport
        self.group = group
        self.seconds = 0.0
        self.calls = 0

    @property
    def coords(self) -> tuple[int, int]:
        """This rank's ``(ix, iy)`` on the mesh."""
        return divmod(self.rank, self.shape[1])

    @classmethod
    def local(cls, device="cpu") -> "Comm":
        """A world of one rank: every collective is local."""
        return cls(0, 1, torch.device(device), None)

    @classmethod
    def from_process_group(cls, device, transport: str, group=None) -> "Comm":
        """This process's rank of an initialised ``torch.distributed`` group."""
        return cls(dist.get_rank(group), dist.get_world_size(group),
                   torch.device(device), transport, group)

    # -- wire -----------------------------------------------------------
    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.transport == "gloo-host" else t

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.transport == "gloo-host" else t

    def _timed(self, fn):
        t0 = _time.perf_counter()
        out = fn()
        self.seconds += _time.perf_counter() - t0
        self.calls += 1
        return out

    # -- collectives ----------------------------------------------------
    def all_gather(self, *tensors: torch.Tensor) -> list:
        """Tiled all-gather of each tensor along dim 0 (``all_gather(...,
        tiled=True)``); every rank's tensors have the same shapes."""
        if self.size == 1:
            return list(tensors)

        def go():
            buf = self._out(_pack(tensors))
            parts = [torch.empty_like(buf) for _ in range(self.size)]
            dist.all_gather(parts, buf, group=self.group)
            per_rank = [_unpack(self._in(p), tensors) for p in parts]
            return [torch.cat([r[i] for r in per_rank])
                    for i in range(len(tensors))]
        return self._timed(go)

    def _peer(self, axis: int, step: int) -> int:
        """The global rank ``step`` places on along mesh axis ``axis``."""
        ix, iy = self.coords
        nx, ny = self.shape
        if axis == 0:
            return ((ix + step) % nx) * ny + iy
        return ix * ny + (iy + step) % ny

    def ring(self, direction: int, *tensors: torch.Tensor,
             axis: int = 0) -> list:
        """``ppermute`` over ``perm(direction, n)`` of mesh axis ``axis``
        (0: x, 1: y): this rank's tensors go to the rank ``direction`` on
        along the axis and those of the rank ``direction`` back come back
        (same shapes on every rank)."""
        if self.shape[axis] == 1:
            return [t.clone() for t in tensors]

        def go():
            buf = self._out(_pack(tensors))
            got = torch.empty_like(buf)
            dst = self._peer(axis, direction)
            src = self._peer(axis, -direction)
            ops = [dist.P2POp(dist.isend, buf, dst, self.group),
                   dist.P2POp(dist.irecv, got, src, self.group)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            return _unpack(self._in(got), tensors)
        return self._timed(go)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return t

        def go():
            buf = self._out(t).clone()
            dist.all_reduce(buf, op=op, group=self.group)
            return self._in(buf)
        return self._timed(go)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """``pmax``: the elementwise maximum over the ranks."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``psum``: the elementwise sum over the ranks."""
        return self._reduce(t, dist.ReduceOp.SUM)
