"""Run one cell of the benchmark of the PyTorch/CUDA port on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints a few lines of its own on standard
error, each number compared with the plain reference beside its limit as
the last lines there, and one JSON object as the last line of standard
output.  Exits non-zero, printing no result, without a CUDA device (or with
fewer than the cell asks for), without the port beside the benchmark, or
if ``jax``, ``jaxlib``, ``flax`` or the JAX package was imported.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
PORT = "particlemethod_fsi_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "particlemethod_fsi_tpu")
# caches of anything the run builds stay inside the checkout, at fixed paths
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is a JAX one."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, PORT)):
        log(f"run: {PORT} is not beside the benchmark in {ROOT}")
        return 2
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(BENCH, "_cache", sub)
    for path in (ROOT, BENCH):
        if path not in sys.path:
            sys.path.insert(0, path)

    import torch
    from fsibench import harness

    spec = harness.cell_spec(args.workload)
    if not torch.cuda.is_available():
        log("run: no CUDA device")
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        log(f"run: {spec['name']} asks for {spec['chips']} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    result, _ = harness.run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_START, log=log)
    found = forbidden_modules()
    if found:
        log(f"run: the process imported {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
