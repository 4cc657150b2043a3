"""The bf16 probe (kernel 7) of this source tree against another tree's, on
the card: each tree's own run of the probe, in turns.

No counterpart in the JAX package.  Runs ``python -m
particlemethod_fsi_tpu_torch.tools.bf16_microbench`` (the probe's own run:
the float32 and packed-bf16 element throughput from the slope between two
trip counts, each tree timing it its own way) in the other tree and in
this one, in turns other, this, this, other, twice over, each a process of
its own that builds its tree's kernels, and reads the ``<type>: ...
Gelem/s slope`` line of each type.  Beside each run, a second process of
the same tree times that tree's ``run`` one way for both (:data:`ALONE`:
single launches held behind a device spin, so that the host's time a call
is not timed; the fastest of five at each trip count).  Prints the card's
name and power limit, then one JSON line: each run's throughput, the mean
of each tree and the bf16 / float32 ratio.

    python -m particlemethod_fsi_tpu_torch.tools.probe_ab --other DIR

``DIR`` is the root of an unpacked copy of another revision (for example
``git archive`` of a parent commit) whose probe prints the same lines.
Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[2]
LINE = re.compile(r"^(float32|bfloat16):.*\(\s*([0-9.]+) Gelem/s slope", re.M)
# the slope of either tree's ``run``, timed the same way; the tiles are
# converted first, which the older ``run`` then leaves as they are
ALONE = """
import torch
from particlemethod_fsi_tpu_torch.tools import bf16_microbench as mb

def fastest(x, y, dtype, reps):
    mb.run(x, y, dtype, reps)
    best = float("inf")
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        mb.run(x, y, dtype, reps)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3)
    return best

x, y = mb.inputs()
for dtype in (torch.float32, torch.bfloat16):
    xd, yd = x.to(dtype), y.to(dtype)
    lo, hi = fastest(xd, yd, dtype, mb.LO), fastest(xd, yd, dtype, mb.HI)
    rate = mb.B * mb.W * (mb.HI - mb.LO) / (hi - lo) / 1e9
    print(f"{str(dtype).split('.')[1]}: ({rate:.1f} Gelem/s slope")
"""


def _run(root: Path, args) -> dict:
    run = subprocess.run([sys.executable, *args], cwd=root,
                         capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise RuntimeError(f"probe in {root} failed:\n{run.stderr[-3000:]}")
    got = {name: float(v) for name, v in LINE.findall(run.stdout)}
    if set(got) != {"float32", "bfloat16"}:
        raise RuntimeError(f"probe in {root} printed:\n{run.stdout}")
    return got


def probe(root: Path) -> dict:
    """The tree at ``root``: Gelem/s of each type from the probe's own run
    (``own``) and from :data:`ALONE` (``alone``)."""
    return {"own": _run(root, ["-m", "particlemethod_fsi_tpu_torch.tools."
                               "bf16_microbench"]),
            "alone": _run(root, ["-c", ALONE])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other tree")
    args = ap.parse_args(argv)
    trees = {"other": args.other.resolve(), "this": THIS}
    runs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other") * 2:
        runs[who].append(probe(trees[who]))
    types = ("float32", "bfloat16")
    means = {how: {who: {t: sum(r[how][t] for r in rs) / len(rs)
                         for t in types} for who, rs in runs.items()}
             for how in ("own", "alone")}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({
        "other": str(args.other), "gelem_per_s": runs, "mean": means,
        "bf16_over_float32": {how: {who: m["bfloat16"] / m["float32"]
                                    for who, m in mh.items()}
                              for how, mh in means.items()},
        "this_over_other": {how: {t: mh["this"][t] / mh["other"][t]
                                  for t in types}
                            for how, mh in means.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
