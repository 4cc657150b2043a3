"""The readings a cell's comparison limits are set from: the program's gaps
to the plain reference over several seeds (the lower readings) and the
control's, the reference a step below float32 put in the program's place
(the upper readings).  Each seed runs a short window at the cell's own load,
long enough to reach the chunk its comparison samples.  The reference is
the configuration's own (``fsibench.harness.reference_for``), on both sides.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 [--control 4,5,6]

Prints one JSON line a run and a summary line; needs the card.
"""

import functools
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr)


def collect(spec: dict, seeds, control, device, out=print,
            log=_stderr) -> dict:
    """The program's runs on ``seeds`` and the control's on ``control``,
    each a JSON line to ``out``: ``{(side, number): [least, most]}``."""
    import torch
    from fsibench import harness
    from fsibench.control import ControlProgram

    control_program = functools.partial(ControlProgram,
                                        bench_dir=spec["bench_dir"])
    worst = {}
    for side, side_seeds, make in (("program", seeds, None),
                                   ("control", control, control_program)):
        for seed in side_seeds:
            r, readings = harness.run_cell(
                spec, seed, 0.0, False, device, time.time(),
                make_program=make, log=log)
            row = {f"{key}.{tag}": v for tag, g in readings.items()
                   for key, v in g.items()}
            row["failed_chunks"] = r["failed"]
            out(json.dumps({"side": side, "seed": seed, **row}))
            for k, v in row.items():
                w = worst.setdefault((side, k), [v, v])
                w[0], w[1] = min(w[0], v), max(w[1], v)
            torch.cuda.empty_cache()
    return worst


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    args = ap.parse_args(argv)
    for path in (ROOT, BENCH):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch
    from fsibench import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    worst = collect(spec, [int(s) for s in args.seeds.split(",") if s],
                    [int(s) for s in args.control.split(",") if s], "cuda:0",
                    out=lambda line: print(line, flush=True))
    print(json.dumps({f"{s}.{k}": v for (s, k), v in worst.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
