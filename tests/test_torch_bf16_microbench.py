"""PyTorch port vs the repository's TPU probe: the packed-bf16 throughput
microbench (``tools/bf16_microbench.py``, whose Pallas ``_kernel`` runs here
in interpret mode) against the port's plain twin of its CUDA kernel, on the
same seeded ``[128, 512]`` tile.

Tolerances, of the largest row sum: float32 rtol 1e-6 (the same float32
operations, rows summed in another order); bf16 1e-2, because XLA on the CPU
evaluates a bf16 elementwise chain in float32 and rounds once at its end,
where the twin (like the CUDA kernel) rounds each operation to bf16.

Also, on the CPU: the kernel's launch plan covers every (row, element, trip)
once and sums each row's block sums in block order; the kernel's packed bf16
masks give the float32 masks for every bf16 value; the count of the trip
loop's machine instructions; and a tile not in the type is refused."""

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
CUDA_SOURCE = os.path.join(REPO, "particlemethod_fsi_tpu_torch", "csrc",
                           "bf16_microbench.cu")


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_bf16_microbench", os.path.join(REPO, "tools", "bf16_microbench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("reps", [REPS, 7])
@pytest.mark.parametrize("dtype,bar", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_twin_matches_the_tpu_kernel(dtype, bar, reps):
    jmb = _jax_probe()
    rng = np.random.default_rng(0)
    x = rng.uniform(0.5, 1.5, (mb.B, mb.W)).astype(np.float32)
    y = rng.uniform(0.5, 1.5, (mb.B, mb.W)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = np.asarray(pl.pallas_call(
        functools.partial(jmb._kernel, acc_dtype=jnp.float32, reps=reps),
        out_shape=jax.ShapeDtypeStruct((mb.B, 1), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True,
    )(jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt)))
    got = mb.run(torch.as_tensor(x), torch.as_tensor(y),
                 getattr(torch, dtype), reps)
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


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("reps", [0, 1, 7, 64, 512, 513, 4096])
def test_plan_covers_every_unit_once(reps, sms):
    """Every (row, element, trip) of the tile is run exactly once, the blocks
    split the units evenly, a block sum's slot is written once, and each
    row's last-block sum reads exactly the slots of its blocks, in block
    order (the kernel's ``first``/``last`` formulas)."""
    for b, w in ((mb.B, mb.W), (3, 64)):
        p = mb.plan(b, w, reps, sms)
        assert p.threads * 2 == w  # a thread a pair: each element once
        assert p.blocks == max(1, min(mb.BLOCKS_PER_SM * sms, b * reps))
        assert b + p.blocks - 1 <= mb.MAX_SLOTS
        cover = np.zeros((b, reps), np.int64)
        slots = {}
        sizes = set()
        for j in range(p.blocks):
            n = 0
            for row, t0, t1, slot in mb.segments(p, j):
                assert 0 <= t0 < t1 <= reps and slot == row + j
                assert slot not in slots
                slots[slot] = (row, j)
                cover[row, t0:t1] += 1
                n += t1 - t0
            sizes.add(n)
        assert (cover == 1).all()
        if reps:
            assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
        for row in range(b):
            want = sorted(j for r, j in slots.values() if r == row)
            assert list(mb.row_blocks(p, row)) == want


@pytest.mark.parametrize("name,const", [("0.25", 0.25), ("0", 0.0),
                                        ("0.1", 0.1)])
def test_packed_masks_equal_float32_masks(name, const):
    """Over all 65,536 bf16 patterns r: the kernel's packed compare of r
    with its bf16 constant gives the twin's float32 compare of r with the
    float32 constant.  0.1f is no bf16 value: the kernel compares with
    0.099609375, the bf16 value below it; bf16(0.1f) would not do."""
    r = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    packed = {0.25: 0.25, 0.0: 0.0, 0.1: 0.099609375}[const]
    assert f"__float2bfloat162_rn({packed}f)" in open(CUDA_SOURCE).read()
    as_bf16 = torch.tensor(packed).bfloat16()
    assert float(as_bf16) == packed  # the constant is a bf16 value
    want = r > np.float32(const)
    got = (torch.from_numpy(r).bfloat16() > as_bf16).numpy()
    np.testing.assert_array_equal(got, want)
    if name == "0.1":
        rounded = torch.tensor(np.float32(0.1)).bfloat16()
        assert float(rounded) == 0.10009765625
        wrong = (torch.from_numpy(r).bfloat16() > rounded).numpy()
        assert (wrong != want).sum() == 1  # r = 0.10009765625 itself


def test_terms_plain_are_the_twins_terms():
    """The twin's chain element by element (the reference of the kernel's
    terms on the card) sums to the twin's rows."""
    x, y = mb.inputs("cpu")
    for dtype in (torch.float32, torch.bfloat16):
        xd, yd = x.to(dtype), y.to(dtype)
        for trip in (0, 5, 12):
            t = mb.terms_plain(xd, yd, trip)
            assert t.shape == x.shape and t.dtype == torch.float32
            k = torch.tensor(1.0 + trip * 0.0625).to(dtype)
            row = mb._chain(xd, yd, k)[:, 0].double()
            # float32 row sums in another order
            np.testing.assert_allclose(t.double().sum(1), row, rtol=0,
                                       atol=1e-6 * float(row.abs().max()))


_SASS = """/*0000*/ MOV R1, c[0x0][0x28] ;
/*0010*/ @P0 BRA 0x40 ;
/*0020*/ FADD R2, R2, R3 ;
/*0030*/ @!P1 BRA 0x20 ;
/*0040*/ FMUL R4, R4, R4 ;
/*0050*/ FADD R5, R4, R2 ;
/*0060*/ MUFU.RSQ R6, R5 ;
/*0070*/ NOP ;
/*0080*/ FSETP.GT.AND P0, PT, R5, 0.25, PT ;
/*0090*/ @P0 BRA 0x40 ;
/*00a0*/ BRA 0x0 ;
/*00b0*/ EXIT ;"""


def test_loop_instructions_counts_the_largest_inner_loop():
    """The loop at 0x40-0x90 (four instructions and the branch, the NOP not
    counted) beats the inner one at 0x20-0x30; the loop at 0x0-0xa0 holds
    both and is not inner."""
    got = mb.loop_instructions(_SASS)
    assert got["instructions"] == 5
    assert got["per_element_trip"] == 5 / (mb.TRIPS_PER_PASS
                                           * mb.ELEMENTS_PER_THREAD)
    assert got["opcodes"] == {"FMUL": 1, "FADD": 1, "MUFU.RSQ": 1,
                              "FSETP.GT.AND": 1, "BRA": 1}
    with pytest.raises(ValueError):
        mb.loop_instructions("/*0000*/ EXIT ;")


def test_a_tile_not_in_the_type_is_refused():
    """The kernel's wrapper converts nothing: a float32 tile for the bf16
    instance, or a strided one, raises before any launch."""
    x, y = mb.inputs("cpu")
    with pytest.raises(ValueError):
        mb._run_cuda(x, y, torch.bfloat16, 4)
    with pytest.raises(ValueError):
        mb._run_cuda(x.t(), y.t(), torch.float32, 4)
    with pytest.raises(ValueError):
        mb.plan(mb.B, 96, 4, 132)
    with pytest.raises(ValueError):
        mb.plan(mb.B, mb.W, mb.MAX_REPS + 1, 132)
