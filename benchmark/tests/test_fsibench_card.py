"""On the card: one short run of each cell through the command, untraced
and traced, correct and with every metric the manifest lists for it.
Needs a CUDA device (the kernels exist only there); skips without one."""

import json
import os
import subprocess
import sys

import pytest

from fsibench import harness


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["dam3d-2m.collapse", "turek-1m.channel"])
def test_cell_runs_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only there")
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2400000001", "--seconds", "2", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    spec = harness.cell_spec(cell)
    want = spec["per_layer"] if trace else spec["end_to_end"]
    assert set(line["metrics"]) == {m["name"] for m in want}
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert os.path.isdir(os.path.join(harness.ROOT, "particlemethod_fsi_tpu_torch"))
