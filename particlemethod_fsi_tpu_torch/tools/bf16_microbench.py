"""Is packed bf16 pair math faster than float32 on this card, and by how much?

Counterpart of the repository's ``tools/bf16_microbench.py`` (a probe of
the TPU's vector unit, not part of the solver): a phase-2-flavoured
elementwise chain (sub, mul, rsqrt, compare, select, row sum; about 21
operations an element) runs ``reps`` times over a ``[128, 512]`` tile in one
kernel launch, in float32 and in packed bf16 with float32 masks, rsqrt and
row sums, and the slope between two trip counts gives the element throughput
of each.  The hand-written kernel is ``csrc/bf16_microbench.cu``; it is not
wired into the solver.

    python -m particlemethod_fsi_tpu_torch.tools.bf16_microbench

runs on the GPU (and fails without one) and prints a line for each type.
:func:`run` launches the kernel for CUDA tensors already in the type (one
launch a call, nothing else), or raises, and takes the plain PyTorch twin
(:func:`run_plain`) only for CPU tensors; :data:`launch_counts` counts the
kernel's launches.  :func:`plan` is the launch plan the kernel follows,
:func:`terms` the kernel's chain element by element (a check), and
:func:`loop_instructions` counts the machine instructions of its trip loop.
"""

from __future__ import annotations

import collections
import functools
import re
from typing import NamedTuple

import torch

from particlemethod_fsi_tpu_torch.ops import cuda_loader

REPS = 512  # trips of the chain in one launch
B, W = 128, 512  # tile: receivers x window lanes
LO, HI = 256, 4096  # the two trip counts of the throughput slope
REPEATS = 5  # timed launches of each, the fastest kept
SPIN_CYCLES = 2_000_000  # device clocks of the spin before a timed launch
SEED = 0  # of the tile
BLOCKS_PER_SM = 4  # blocks of the grid an SM (1,024 threads at the tile's w)
# limits of the kernel (csrc/bf16_microbench.cu): k = 1 + i / 16 stays exact
# in float32 below MAX_REPS trips; the block sums have MAX_SLOTS places
MAX_REPS = 1 << 20
MAX_SLOTS = 1 << 16
# the kernel's trip loop: trips a pass, elements (one pair) a thread
TRIPS_PER_PASS, ELEMENTS_PER_THREAD = 4, 2

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


class Plan(NamedTuple):
    """The kernel's launch: ``blocks`` blocks of ``threads`` threads, one for
    each element pair of a row, over the ``b * reps`` (row, trip) units in
    row-major order.  Block ``j`` runs units ``[units j / blocks, units
    (j + 1) / blocks)`` (:func:`segments`); the kernel computes the same
    ranges from these numbers."""
    b: int
    reps: int
    blocks: int
    threads: int

    @property
    def units(self) -> int:
        return self.b * self.reps


def plan(b: int, w: int, reps: int, sms: int) -> Plan:
    """The launch for a ``[b, w]`` tile and ``reps`` trips on a card of
    ``sms`` SMs: :data:`BLOCKS_PER_SM` blocks an SM, or one a unit where
    there are fewer units (one block for no trip at all)."""
    if w % 64 or not 0 < w // 2 <= 1024:
        raise ValueError(f"bf16_microbench: w={w} is not a multiple of 64 "
                         "up to 2048")
    if not 0 <= reps <= MAX_REPS:
        raise ValueError(f"bf16_microbench: reps={reps} outside [0, "
                         f"{MAX_REPS}]")
    blocks = max(1, min(BLOCKS_PER_SM * sms, b * reps))
    if b + blocks - 1 > MAX_SLOTS:
        raise ValueError(f"bf16_microbench: {b} rows and {blocks} blocks "
                         f"need more than {MAX_SLOTS} block sums")
    return Plan(b, reps, blocks, w // 2)


def segments(p: Plan, j: int):
    """Block ``j``'s rows: ``(row, first trip, end trip, slot)`` for each
    row it touches, in order.  Each thread of the block runs its element
    pair of the row over those trips; the block's sum goes to ``slot``."""
    u, u1 = p.units * j // p.blocks, p.units * (j + 1) // p.blocks
    while u < u1:
        row, t0 = divmod(u, p.reps)
        t1 = min(p.reps, t0 + u1 - u)
        yield row, t0, t1, row + j
        u += t1 - t0


def row_blocks(p: Plan, row: int) -> range:
    """The blocks whose sums the kernel's last block adds, in order, into
    ``row``: from the first whose units end past ``row * reps`` to the last
    whose units begin before ``(row + 1) * reps``."""
    if p.units == 0:
        return range(0)
    first = -(-((row * p.reps + 1) * p.blocks) // p.units) - 1
    last = -(-((row + 1) * p.reps * p.blocks) // p.units) - 1
    return range(first, last + 1)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, y, dtype):
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bf16_microbench: unsupported dtype {dtype}")
    if (x.dtype != dtype or y.dtype != dtype or x.shape != y.shape
            or x.dim() != 2 or y.device != x.device
            or not (x.is_contiguous() and y.is_contiguous())):
        raise ValueError(f"bf16_microbench: x and y must be contiguous [b, w] "
                         f"{dtype} tiles on one device")


def _run_cuda(x, y, dtype, reps):
    _check(x, y, dtype)
    b, w = x.shape
    p = plan(b, w, reps, _sms(x.device.index))
    out = torch.empty((b, 1), dtype=torch.float32, device=x.device)
    lib = cuda_loader.load()
    with torch.cuda.device(x.device):
        err = lib.fsi_bf16_microbench(
            int(dtype == torch.bfloat16), x.data_ptr(), y.data_ptr(),
            out.data_ptr(), b, w, reps, p.blocks,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"bf16_microbench: launch refused (cudaGetLastError = {err}; -1 "
            "means the arguments are outside what the kernel takes)")
    launch_counts["bf16_microbench"] += 1
    return out


def run(x: torch.Tensor, y: torch.Tensor, dtype: torch.dtype,
        reps: int) -> torch.Tensor:
    """``[B, 1]`` float32 sums of ``reps`` trips of the chain over the tile
    ``(x, y)`` in ``dtype`` (float32 or bfloat16).  CUDA tensors must be
    contiguous tiles already in ``dtype`` and go through the hand-written
    kernel (one launch) or the call raises; only CPU tensors take
    :func:`run_plain`."""
    if x.is_cuda:
        return _run_cuda(x, y, dtype, reps)
    return run_plain(x, y, dtype, reps)


def terms(x: torch.Tensor, y: torch.Tensor, trip: int) -> torch.Tensor:
    """Each element's term at trip ``trip`` from the kernel's own chain
    (``fsi_bf16_microbench_terms``, in the type of the CUDA tensors ``x``
    and ``y``), float32 of their shape: a check, not counted in
    :data:`launch_counts`."""
    _check(x, y, x.dtype)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lib = cuda_loader.load()
    with torch.cuda.device(x.device):
        err = lib.fsi_bf16_microbench_terms(
            int(x.dtype == torch.bfloat16), x.data_ptr(), y.data_ptr(),
            out.data_ptr(), x.numel(), trip,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bf16_microbench terms: launch refused ({err})")
    return out


def terms_plain(x: torch.Tensor, y: torch.Tensor, trip: int) -> torch.Tensor:
    """The twin's terms at trip ``trip``: its chain on every element as a
    row of its own (a row sum of one term is that term, with -0 as +0)."""
    dt = x.dtype
    kf = torch.tensor(1.0 + trip * 0.0625, dtype=torch.float32)
    return _chain(x.reshape(-1, 1), y.reshape(-1, 1),
                  kf.to(dt).to(x.device)).reshape(x.shape)


def inputs(device="cuda", dtype=torch.float32):
    """The probe's tile: x and y uniform in [0.5, 1.5), float32, seeded,
    then converted to ``dtype``."""
    g = torch.Generator().manual_seed(SEED)
    x = torch.rand((B, W), generator=g) + 0.5
    y = torch.rand((B, W), generator=g) + 0.5
    return x.to(device=device, dtype=dtype), y.to(device=device, dtype=dtype)


_INSTRUCTION = re.compile(r"^/\*([0-9a-f]+)\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)$")


def loop_instructions(sass: str) -> dict:
    """The trip loop of one kernel function's machine code (the lines of
    ``cuobjdump -sass``, as :func:`cuda_loader.sass` gives them): the largest
    loop (a backward branch and its target) that holds no other loop.
    Returns its instruction count without NOPs, the count per element-trip
    (:data:`TRIPS_PER_PASS` trips of :data:`ELEMENTS_PER_THREAD` elements a
    pass) and the count of each opcode."""
    code = []
    for line in sass.splitlines():
        m = _INSTRUCTION.match(line.strip())
        if m:
            code.append((int(m.group(1), 16), m.group(2)))
    loops = []
    for addr, ins in code:
        m = _BRANCH.search(ins)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [a for a in loops if not any(
        b != a and a[0] <= b[0] and b[1] <= a[1] for b in loops)]
    if not inner:
        raise ValueError("bf16_microbench: no loop in the machine code")
    body = []
    for start, end in inner:
        ops = [re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
               for addr, ins in code if start <= addr <= end]
        ops = [op for op in ops if op != "NOP"]
        body = max(body, ops, key=len)
    return dict(instructions=len(body),
                per_element_trip=len(body) / (TRIPS_PER_PASS
                                              * ELEMENTS_PER_THREAD),
                opcodes=dict(collections.Counter(body).most_common()))


def kernel_sass() -> dict:
    """``{"float32": ..., "bfloat16": ...}``: :func:`loop_instructions` of
    each instance of the kernel in the built library."""
    code = cuda_loader.sass(cuda_loader.load())
    out = {}
    for name, text in code.items():
        if "bf16_microbench_kernel" in name:
            out["bfloat16" if "bfloat162" in name else "float32"] = (
                loop_instructions(text))
    return out


def time_launch(x, y, dtype, reps: int) -> float:
    """Fastest of :data:`REPEATS` launches, in seconds, by CUDA events
    around the kernel alone: a spin on the device (~1 ms) holds the start
    event back until the host has enqueued the launch, so that the host's
    time a call (tens of microseconds, and varying) is not timed."""
    run(x, y, dtype, reps)
    best = float("inf")
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
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
    for dtype in (torch.float32, torch.bfloat16):
        x, y = inputs(dtype=dtype)
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
