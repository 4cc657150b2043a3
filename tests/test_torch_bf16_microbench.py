"""PyTorch port vs the repository's TPU probe: the packed-bf16 throughput
microbench (``tools/bf16_microbench.py``, whose Pallas ``_kernel`` runs here
in interpret mode) against the port's plain twin of its CUDA kernel, on the
same seeded ``[128, 512]`` tile.

Tolerances, of the largest row sum: float32 rtol 1e-6 (the same float32
operations, rows summed in another order); bf16 1e-2, because XLA on the CPU
evaluates a bf16 elementwise chain in float32 and rounds once at its end,
where the twin (like the CUDA kernel) rounds each operation to bf16."""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from particlemethod_fsi_tpu_torch.tools import bf16_microbench as mb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 12


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_bf16_microbench", os.path.join(REPO, "tools", "bf16_microbench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_twin_matches_the_tpu_kernel(dtype, bar):
    jmb = _jax_probe()
    rng = np.random.default_rng(0)
    x = rng.uniform(0.5, 1.5, (mb.B, mb.W)).astype(np.float32)
    y = rng.uniform(0.5, 1.5, (mb.B, mb.W)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = np.asarray(pl.pallas_call(
        functools.partial(jmb._kernel, acc_dtype=jnp.float32, reps=REPS),
        out_shape=jax.ShapeDtypeStruct((mb.B, 1), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True,
    )(jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt)))
    got = mb.run(torch.as_tensor(x), torch.as_tensor(y),
                 getattr(torch, dtype), REPS)
    assert mb.launch_counts == {"bf16_microbench": 0}
    assert got.shape == want.shape == (mb.B, 1) and got.dtype == torch.float32
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bar * scale)
    assert (mb.B, mb.W, mb.REPS) == (jmb.B, jmb.W, jmb.REPS)


def test_cuda_tensor_never_takes_the_twin(monkeypatch):
    class FakeCuda:
        is_cuda = True

    def boom(*a, **k):
        raise AssertionError("plain twin called for a CUDA tensor")

    monkeypatch.setattr(mb, "run_plain", boom)
    with pytest.raises(Exception) as e:
        mb.run(FakeCuda(), FakeCuda(), torch.float32, 4)
    assert not isinstance(e.value, AssertionError)
