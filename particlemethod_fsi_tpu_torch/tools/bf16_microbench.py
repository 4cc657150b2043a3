"""Is packed bf16 pair math about twice as fast as float32 on this card?

Counterpart of the repository's ``tools/bf16_microbench.py`` (a probe of
the TPU's vector unit, not part of the solver): a phase-2-flavoured
elementwise chain (sub, mul, rsqrt, compare, select, row sum; about 21
operations an element) runs ``reps`` times over a ``[128, 512]`` tile in one
kernel launch, in float32 and in packed bf16 with float32 masks, rsqrt and
row sums, and the slope between two trip counts gives the element throughput
of each.  The hand-written kernel is ``csrc/bf16_microbench.cu``; it is not
wired into the solver.

    python -m particlemethod_fsi_tpu_torch.tools.bf16_microbench

runs on the GPU (and fails without one).  :func:`run` launches the kernel
for CUDA tensors, or raises, and takes the plain PyTorch twin
(:func:`run_plain`) only for CPU tensors; :data:`launch_counts` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import time

import torch

from particlemethod_fsi_tpu_torch.ops import cuda_loader

REPS = 512  # trips of the chain in one launch
B, W = 128, 512  # tile: receivers x window lanes
LO, HI = 256, 4096  # the two trip counts of the throughput slope
REPEATS = 5  # timed launches of each, the fastest kept
SEED = 0  # of the tile
SPLITS = 64  # blocks a row: the trips are split so that the card is full

launch_counts = {"bf16_microbench": 0}

# operations an element a trip, counted from the chain: dxx, dyy, r2 (3),
# compare, select, rsqrt, rij, omq (2), mask (3), w1, w2, radial (4), sum
OPS_PER_ELEMENT = 21


def _chain(x, y, k):
    """One trip of the chain (``_chain`` of the JAX probe), summed over each
    row in float32: ``[B, 1]``.  In bf16 the masks are float32 compares and
    the rsqrt a float32 rsqrt rounded to bf16, as there; every constant is a
    tensor of the element type, so it is rounded to that type first."""
    dt, dev = x.dtype, x.device

    def c(v):
        return torch.tensor(v, dtype=dt, device=dev)

    dxx = x - k
    dyy = y + k
    r2 = dxx * dxx + dyy * dyy
    if dt == torch.bfloat16:
        r2f = r2.float()
        m0 = r2f > 0.25
        r2sf = torch.where(m0, r2f, torch.ones_like(r2f))
        inv_r = torch.rsqrt(r2sf).to(dt)
        r2s = r2sf.to(dt)
        m_r2 = r2f > 0.1
    else:
        m0 = r2 > 0.25
        r2s = torch.where(m0, r2, c(1.0))
        inv_r = torch.rsqrt(r2s)
        m_r2 = r2 > 0.1
    rij = r2s * inv_r
    omq = c(1.0) - rij * c(0.4)
    m = m_r2 & (omq.float() > 0)
    w1 = omq * omq
    w2 = w1 * rij
    radial = torch.where(m, w2 * dxx + w1 * dyy, c(0.0))
    return radial.float().sum(dim=1, keepdim=True)


def run_plain(x: torch.Tensor, y: torch.Tensor, dtype: torch.dtype,
              reps: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: ``[B, 1]`` float32 sums over
    ``reps`` trips, trip ``i`` with ``k = 1 + i / 16`` (float32, then the
    element type)."""
    x, y = x.to(dtype), y.to(dtype)
    acc = torch.zeros((x.shape[0], 1), dtype=torch.float32, device=x.device)
    for i in range(reps):
        kf = torch.tensor(1.0 + i * 0.0625, dtype=torch.float32)
        acc = acc + _chain(x, y, kf.to(dtype).to(x.device))
    return acc


def _run_cuda(x, y, dtype, reps):
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bf16_microbench: unsupported dtype {dtype}")
    if x.shape != y.shape or x.dim() != 2 or y.device != x.device:
        raise ValueError("bf16_microbench: x and y must be [b, w] on one device")
    b, w = x.shape
    xs, ys = x.to(dtype).contiguous(), y.to(dtype).contiguous()
    partial = torch.empty((SPLITS, b), dtype=torch.float32, device=x.device)
    lib = cuda_loader.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fsi_bf16_microbench(
            int(dtype == torch.bfloat16), xs.data_ptr(), ys.data_ptr(),
            partial.data_ptr(), b, w, reps, SPLITS, stream)
    if err != 0:
        raise RuntimeError(
            f"bf16_microbench: launch refused (cudaGetLastError = {err}; -1 "
            "means the arguments are outside what the kernel takes)")
    launch_counts["bf16_microbench"] += 1
    return partial.sum(dim=0)[:, None]


def run(x: torch.Tensor, y: torch.Tensor, dtype: torch.dtype,
        reps: int) -> torch.Tensor:
    """``[B, 1]`` float32 sums of ``reps`` trips of the chain over the tile
    ``(x, y)`` in ``dtype`` (float32 or bfloat16).  CUDA tensors go through
    the hand-written kernel or the call raises; only CPU tensors take
    :func:`run_plain`."""
    if x.is_cuda:
        return _run_cuda(x, y, dtype, reps)
    return run_plain(x, y, dtype, reps)


def inputs(device="cuda"):
    """The probe's tile: x and y uniform in [0.5, 1.5), float32, seeded."""
    g = torch.Generator().manual_seed(SEED)
    x = torch.rand((B, W), generator=g) + 0.5
    y = torch.rand((B, W), generator=g) + 0.5
    return x.to(device), y.to(device)


def time_launch(x, y, dtype, reps: int) -> float:
    """Fastest of :data:`REPEATS` launches, in seconds, by CUDA events."""
    run(x, y, dtype, reps)
    best = float("inf")
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(x, y, dtype, reps)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3)
    return best


def throughput(x, y, dtype) -> dict:
    """Element throughput from the slope between :data:`LO` and :data:`HI`
    trips (the fixed launch cost cancels)."""
    t_lo = time_launch(x, y, dtype, LO)
    t_hi = time_launch(x, y, dtype, HI)
    per_trip = (t_hi - t_lo) / (HI - LO)
    elems = x.shape[0] * x.shape[1]
    return dict(ns_per_trip=per_trip * 1e9, elements_per_s=elems / per_trip,
                seconds_lo=t_lo, seconds_hi=t_hi)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bf16_microbench: no CUDA device")
    x, y = inputs()
    for dtype in (torch.float32, torch.bfloat16):
        r = throughput(x, y, dtype)
        acc = run(x, y, dtype, REPS)
        print(f"{str(dtype).split('.')[1]}: {r['ns_per_trip']:9.3f} ns/trip "
              f"({r['elements_per_s'] / 1e9:8.1f} Gelem/s slope; "
              f"lo={r['seconds_lo'] * 1e6:.0f}us hi={r['seconds_hi'] * 1e6:.0f}us), "
              f"acc[:3]={acc[:3, 0].tolist()}")
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
