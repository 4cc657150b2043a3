"""Summarize a case run's metrics JSONL into a compact markdown table
(momentum / kinetic-energy / max-speed sanity at VTK cadence).

Counterpart of the repository's ``tools/case_summary.py``: the same usage
and, for the same file, the same text.

    python -m particlemethod_fsi_tpu_torch.tools.case_summary <metrics.jsonl> [every_k]
"""

from __future__ import annotations

import json
import sys


def output_rows(path) -> list:
    """The metrics lines written at output time (those with a kinetic
    energy), in file order."""
    with open(path) as f:
        return [m for m in map(json.loads, f) if "kinetic_energy" in m]


def picks(rows: list, every: int) -> list:
    """Every ``every``-th row, and the last."""
    out = rows[::every]
    if rows and rows[-1] is not (out[-1] if out else None):
        out.append(rows[-1])
    return out


def summary(path, every: int = 10) -> str:
    lines = ["| step | time | max speed [m/s] | KE [J] | px [kg m/s] "
             "| py [kg m/s] | nbr max | window len |",
             "|---|---|---|---|---|---|---|---|"]
    for m in picks(output_rows(path), every):
        lines.append(
            f"| {m['step']} | {m['time']:.3f} | {m['max_speed']:.4f} "
            f"| {m['kinetic_energy']:.4e} | {m['momentum_x']:+.3e} "
            f"| {m['momentum_y']:+.3e} | {m['neighbor_max']} "
            f"| {m.get('window_len', 0)} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    every = int(argv[1]) if len(argv) > 1 else 10
    sys.stdout.write(summary(argv[0], every))
    return 0


if __name__ == "__main__":
    sys.exit(main())
