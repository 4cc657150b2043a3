"""Every pair of particles closer than a cut-off, on a periodic box, in
plain PyTorch: a cell list with cells at least the cut-off wide, and of the
cells around a particle only one half shell, so that each pair is found once.

Used by the plain reference (its neighbour lists) and by the roofline
readers (the pairs in range, counted from the states themselves, whatever
the program's kernels walk).  Imports neither the port nor the JAX package.
"""

from __future__ import annotations

import itertools

import torch


def min_image(d: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """The reference's ``Mod(dx + W/2, W) - W/2`` (src/main.cpp:98)."""
    half = 0.5 * width
    y = d + half
    return y - width * torch.floor(y / width) - half


def wrap(pos: torch.Tensor, dmin: torch.Tensor, width: torch.Tensor):
    """Positions into the box (calculatePeriodicBoundary,
    src/main.cpp:3322-3333)."""
    rel = pos - dmin
    return rel - width * torch.floor(rel / width) + dmin


def _half_shell(nc):
    """Cell offsets after (0, ..., 0) in lexicographic order: each pair of
    neighbouring cells once.  An axis of one cell has only the offset 0."""
    steps = [(-1, 0, 1) if c >= 3 else (0,) for c in nc]
    return [o for o in itertools.product(*steps) if o > (0,) * len(nc)]


def build_pairs(pos: torch.Tensor, dmin, width, cutoff: float, *,
                block: int = 1 << 18):
    """Pairs ``(a, b)``, ``a != b``, of the rows of ``pos`` ([N, dim]) at a
    minimum-image distance below ``cutoff``, each once: two int64 tensors
    into ``pos``.  Every axis is periodic, as in the reference; an axis
    narrower than three cut-offs is one cell."""
    dev = pos.device
    n, dim = pos.shape
    dmin_t = torch.as_tensor(dmin[:dim], dtype=pos.dtype, device=dev)
    width_t = torch.as_tensor(width[:dim], dtype=pos.dtype, device=dev)
    nc = [int(w // cutoff) for w in width[:dim]]
    nc = [c if c >= 3 else 1 for c in nc]
    cw = torch.as_tensor([w / c for w, c in zip(width[:dim], nc)],
                         dtype=pos.dtype, device=dev)
    ncs = torch.as_tensor(nc, dtype=torch.int64, device=dev)
    cell = torch.floor((wrap(pos, dmin_t, width_t) - dmin_t) / cw).long()
    cell = torch.minimum(torch.clamp_min(cell, 0), ncs - 1)
    stride = [1]
    for c in nc[:-1]:
        stride.append(stride[-1] * c)
    stride_t = torch.as_tensor(stride, dtype=torch.int64, device=dev)
    key = (cell * stride_t).sum(dim=1)
    order = torch.argsort(key)
    key_s = key[order]
    cell_s = cell[order]
    pos_s = pos[order]
    ncell = int(torch.prod(ncs))
    count = torch.bincount(key_s, minlength=ncell)
    start = torch.cumsum(count, 0) - count
    offsets = torch.as_tensor(_half_shell(nc), dtype=torch.int64,
                              device=dev).reshape(-1, dim)
    cut2 = cutoff * cutoff
    out_a, out_b = [], []
    for a0 in range(0, n, block):
        a = torch.arange(a0, min(n, a0 + block), device=dev)
        ca = cell_s[a]
        own = key_s[a]
        # the own cell: the rows after this one
        cand = [(a + 1, start[own] + count[own] - a - 1)]
        for off in offsets:
            nb = ((ca + off) % ncs * stride_t).sum(dim=1)
            cand.append((start[nb], count[nb]))
        for first, cnt in cand:
            cnt = torch.clamp_min(cnt, 0)
            total = int(cnt.sum())
            if total == 0:
                continue
            ia = torch.repeat_interleave(a, cnt, output_size=total)
            base = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt,
                                           output_size=total)
            ib = (torch.repeat_interleave(first, cnt, output_size=total)
                  + torch.arange(total, device=dev) - base)
            d = min_image(pos_s[ib] - pos_s[ia], width_t)
            keep = (d * d).sum(dim=1) < cut2
            out_a.append(ia[keep])
            out_b.append(ib[keep])
    if not out_a:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty
    return order[torch.cat(out_a)], order[torch.cat(out_b)]


def count_pairs(pos: torch.Tensor, dmin, width, radius: float) -> int:
    """Ordered pairs ``(i, j)``, ``i != j``, closer than ``radius``: what a
    receiver-by-receiver sweep finds inside its kernel radius."""
    a, _ = build_pairs(pos, dmin, width, radius)
    return 2 * int(a.shape[0])
