"""The roofline arithmetic of the window kernels, frozen.

Copied from ``chip_smoke.py:173-218`` at commit 59262f8 (the published peaks
of one H100 SXM and the float operations and bytes each kernel needs, counted
from the formulas); the kernels' rows this benchmark does not read are left
out.  A later change to ``chip_smoke.py`` does not move this yardstick.
"""

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12
# Each window kernel's bound counts: (a planar frame, a 3-D frame), both at
# the main paths' flags (no surface tension, uniform ratios and radii, no
# count).
# Float operations a pair inside the kernel radius, counted from the
# formulas.  Planar: separation and rij2 (5), rsqrt, r, q, 1-q (4); phase 1
# adds the wp sum (2) and the divergence (9); phase 2 adds the unit vector
# (2), the pressure term (5), the viscosity term (14) and the force sums (4).
# 3-D adds the z terms: rij2 (+3), the divergence's or the viscosity's
# velocity term (+3), the unit vector's z (+1), phase 2's fz sum (+2).
FLOP_PER_PAIR = {"phase1_sweep": (20, 26), "phase2_sweep": (34, 43)}
# Bytes a particle that the function needs, float32.  Phase 1 reads x, y,
# vx, vy and the key and writes the wp sum and the divergence; the
# density-A, gravity-centre and count rows are zero there, and in a planar
# frame z, vz are never used.  Phase 2 reads x, y, vx, vy, pressure P, 1/mu,
# key and type and writes fx, fy.  3-D adds z and vz read, and phase 2's fz
# written.
BYTES_PER_PARTICLE = {
    "phase1_sweep": (5 * 4 + 2 * 4, 7 * 4 + 2 * 4),
    "phase2_sweep": (8 * 4 + 2 * 4, 10 * 4 + 3 * 4),
}


def least_seconds(kernel: str, pairs: float, particles: float,
                  three_d: bool) -> float:
    """The least time of one launch: the operations of ``pairs`` ordered
    pairs inside the kernel radius over the float32 peak, or the bytes of
    ``particles`` particles (each counted once) over the memory rate,
    whichever is longer."""
    d3 = int(three_d)
    return max(pairs * FLOP_PER_PAIR[kernel][d3] / PEAK_FLOP_PER_S,
               particles * BYTES_PER_PARTICLE[kernel][d3] / PEAK_BYTES_PER_S)
