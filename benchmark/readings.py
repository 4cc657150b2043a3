"""The readings a cell's comparison limits are set from: the program's gaps
to the plain reference over several seeds (the lower readings) and the
control's, the reference a step below float32 put in the program's place
(the upper readings).  Each seed runs a short window at the cell's own load,
long enough to reach the chunk its comparison samples.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 [--control 4,5,6]

Prints one JSON line a run and a summary line; needs the card.
"""

import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


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
    from fsibench.control import ControlProgram

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    worst = {}
    for side, seeds, make in (("program", args.seeds, None),
                              ("control", args.control, ControlProgram)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            r, readings = harness.run_cell(
                spec, seed, 0.0, False, "cuda:0", time.time(),
                make_program=make, log=lambda m: print(m, file=sys.stderr))
            row = {f"{key}.{tag}": v for tag, g in readings.items()
                   for key, v in g.items()}
            row["failed_chunks"] = r["failed"]
            print(json.dumps({"side": side, "seed": seed, **row}), flush=True)
            for k, v in row.items():
                w = worst.setdefault((side, k), [v, v])
                w[0], w[1] = min(w[0], v), max(w[1], v)
            torch.cuda.empty_cache()
    print(json.dumps({f"{s}.{k}": v for (s, k), v in worst.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
