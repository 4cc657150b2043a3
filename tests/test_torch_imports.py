"""The PyTorch port stands alone: it imports and runs with ``jax``, ``flax``
and the JAX package made unimportable, its sources name none of them, its
kernel modules import without a compiler or a card, a rank it spawns imports
none of them either, and without ``device="cpu"`` it raises on a machine
with no GPU."""

import os
import re
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "particlemethod_fsi_tpu_torch")

_BLOCK = textwrap.dedent("""
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "flax", "particlemethod_fsi_tpu"):
                raise ImportError("blocked for this test: " + name)
            return None

    sys.meta_path.insert(0, Block())
""")


def _run(body: str):
    return subprocess.run(
        [sys.executable, "-c", _BLOCK + textwrap.dedent(body)], cwd=REPO,
        capture_output=True, text=True, timeout=300)


def test_port_runs_with_jax_unimportable():
    r = _run("""
        import torch
        import particlemethod_fsi_tpu_torch as port
        from particlemethod_fsi_tpu_torch.models import build_case
        from particlemethod_fsi_tpu_torch.ops import windows, windows_t, cuda_loader
        from particlemethod_fsi_tpu_torch.tools import bf16_microbench
        for blocked in ("jax", "flax", "particlemethod_fsi_tpu"):
            try:
                __import__(blocked)
            except ImportError:
                pass
            else:
                raise SystemExit(blocked + " was importable")
        sim = build_case(12, device="cpu", dtype="float64", pallas_block=32)
        out = sim.run_chunk(sim.state0, 2)
        assert bool(torch.isfinite(out.pos).all())
        assert sim.rebuilds >= 1
        # the row-major backend, and the probe's plain twin
        rows = build_case(12, device="cpu", dtype="float64", pallas_block=32,
                          backend="pallas")
        out = rows.run_chunk(rows.state0, 2)
        assert bool(torch.isfinite(out.pos).all()) and rows.rebuilds == 2
        d = rows.diagnostics(out)
        assert abs(d["virial_pressure"]).max() > 0
        # a periodic scene: the Turek channel on a ghost-extended frame
        from particlemethod_fsi_tpu_torch.models import build_turek
        from particlemethod_fsi_tpu_torch.ops import ghosts
        tk = build_turek(5e-3, device="cpu", dtype="float64", pallas_block=32)
        assert tk._ghosts is not None and ghosts.spec_axes(tk._ghosts)[0]
        out = tk.run_chunk(tk.state0, 1)
        assert bool(torch.isfinite(out.pos).all()) and tk.rebuilds == 1
        # a 3-D frame (plane-padded) and rocking walls
        from particlemethod_fsi_tpu_torch.config import NumericsConfig
        from particlemethod_fsi_tpu_torch.models import dam_break_3d, rolling_tank
        from particlemethod_fsi_tpu_torch.solver import Simulation
        nm = NumericsConfig(dtype="float64", pallas_block=32)
        s3 = Simulation(*dam_break_3d(n_side=4, numerics=nm), device="cpu")
        out = s3.run_chunk(s3.state0, 1)
        assert s3._pad_planes and bool(torch.isfinite(out.pos).all())
        rt = Simulation(*rolling_tank(n_side=8, numerics=nm), device="cpu")
        out = rt.run_chunk(rt.state0, 1)
        assert not rt._walls_static and bool(torch.isfinite(out.pos).all())
        # the candidate engines, with no kernel launched
        for engine in ("packed", "gather"):
            ce = build_case(12, device="cpu", dtype="float64", backend=engine)
            out = ce.run_chunk(ce.state0, 2)
            assert bool(torch.isfinite(out.pos).all()) and ce.rebuilds == 2
            assert ce.diagnostics(out)["window_overflow"] == 0
        assert not any(windows.launch_counts.values())
        x, y = bf16_microbench.inputs(device="cpu")
        acc = bf16_microbench.run(x[:4], y[:4], torch.bfloat16, 2)
        assert acc.shape == (4, 1) and bool(torch.isfinite(acc).all())
        assert windows_t.launch_counts is windows.launch_counts
        assert windows.launch_counts == {
            "phase1_sweep": 0, "phase2_sweep": 0, "virial_sweep": 0,
            "phase1_rows": 0, "phase2_rows": 0, "virial_rows": 0}
        assert bf16_microbench.launch_counts == {"bf16_microbench": 0}
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "triton")]
        print("PORT_OK", sim.n)
    """)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "PORT_OK" in r.stdout


def test_command_line_runs_with_jax_unimportable(tmp_path):
    """Every module of the port imports, and ``cli.main`` runs a case from
    files to files (generator command, ``.data`` writer, both outputs, the
    diagnostics with the virial's plain version, a checkpoint), with ``jax``,
    ``flax`` and the JAX package blocked."""
    r = _run(f"""
        import importlib, os, pkgutil, sys
        import particlemethod_fsi_tpu_torch as port
        names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                       port.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        for want in ("cli", "io.data_file", "io.native", "io.vtk_writer",
                     "io.grid_file", "utils.logging", "utils.watchdog",
                     "utils.checkpoint", "generator", "convert",
                     "ops.windows", "ops.windows_t", "ops.ghosts",
                     "ops.edge_math", "ops.packed_engine", "ops.neighbors",
                     "models.turek", "models.cases", "models.wave",
                     "parallel.comm", "parallel.launch", "parallel.sharding",
                     "parallel.halo", "tools.bf16_microbench"):
            assert port.__name__ + "." + want in names, want
        from particlemethod_fsi_tpu_torch import cli
        from particlemethod_fsi_tpu_torch.io import write_data_file, write_grid_file
        from particlemethod_fsi_tpu_torch.models import bench_config, bench_grid
        from particlemethod_fsi_tpu_torch.ops import windows_t
        d = {str(tmp_path)!r}
        write_data_file(bench_config().replace(
            output_interval=3e-4, vtk_output_interval=3e-4, end_time=3e-4),
            d + "/b.data")
        write_grid_file(bench_grid(12), d + "/b.grid")
        rc = cli.main([d + "/b.data", d + "/b.grid", d + "/b%03d.prof",
                       d + "/b%03d.vtk", d + "/b.log", "--scene", "dam",
                       "--device", "cpu", "--dtype", "float64",
                       "--rebuild-margin", "0.5", "--metrics", d + "/m.jsonl",
                       "--checkpoint", d + "/ck%03d.npz"])
        assert rc == 0, rc
        made = sorted(os.listdir(d))
        assert made == ["b.data", "b.grid", "b.log", "b000.prof", "b000.vtk",
                        "b003.prof", "b003.vtk", "ck000.npz", "ck003.npz",
                        "m.jsonl"], made
        assert "VirialPressureAtParticle" in open(d + "/b003.vtk").read()
        assert not any(windows_t.launch_counts.values())
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "triton")]
        print("CLI_OK")
    """)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "CLI_OK" in r.stdout


def test_a_spawned_rank_imports_neither_jax_nor_the_jax_package():
    """Two gloo ranks started from a process with ``jax``, ``flax`` and the
    JAX package blocked run a halo and an all-gather step; each rank (a
    fresh interpreter, with no block of its own) reports the top-level
    modules it imported."""
    r = _run("""
        from particlemethod_fsi_tpu_torch.models import bench_config, bench_grid
        from particlemethod_fsi_tpu_torch.parallel import launch
        if __name__ == "__main__":
            cfg = bench_config(dtype="float64", pallas_block=32)
            job = dict(cfg=cfg, grid=bench_grid(12), script=[("run", 1)])
            ranks = launch.spawn(
                launch.run_jobs, 2,
                [dict(job, mode="halo"), dict(job, mode="allgather")],
                transport="gloo", timeout=100, threads=1)
            for r in ranks:
                bad = {"jax", "jaxlib", "flax", "particlemethod_fsi_tpu"}
                assert not bad & set(r["modules"]), r["modules"]
                assert "torch" in r["modules"]
                assert r["jobs"][0][0]["engine"] == "pallas_t"
            print("RANKS_OK")
    """)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "RANKS_OK" in r.stdout


def test_command_line_without_a_gpu_exits_and_writes_nothing(tmp_path):
    r = _run(f"""
        import os, torch
        from particlemethod_fsi_tpu_torch import cli
        if torch.cuda.is_available():
            print("HAS_GPU")
            raise SystemExit(0)
        d = {str(tmp_path)!r}
        try:
            cli.main(["x.data", "x.grid", d + "/o%03d.prof", d + "/o%03d.vtk",
                      d + "/o.log", "--metrics", d + "/m.jsonl"])
        except SystemExit as e:
            assert e.code not in (0, None), e.code
            print("EXITED", e.code)
        else:
            raise SystemExit("carried on on the CPU")
        assert os.listdir(d) == []
    """)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "HAS_GPU" in r.stdout or "EXITED" in r.stdout


def test_without_device_cpu_it_raises_where_there_is_no_gpu():
    r = _run("""
        import torch
        from particlemethod_fsi_tpu_torch.models import bench_config, bench_grid
        from particlemethod_fsi_tpu_torch.solver import Simulation
        if torch.cuda.is_available():
            print("HAS_GPU")
            raise SystemExit(0)
        try:
            Simulation(bench_config(), bench_grid(12))
        except RuntimeError as e:
            print("RAISED", e)
        else:
            raise SystemExit("carried on on the CPU")
        try:
            Simulation(bench_config(), bench_grid(12), device="cuda")
        except RuntimeError as e:
            print("RAISED_CUDA", e)
        else:
            raise SystemExit("carried on on the CPU")
    """)
    assert r.returncode == 0, r.stderr[-2000:]
    if "HAS_GPU" not in r.stdout:
        assert "RAISED" in r.stdout and "RAISED_CUDA" in r.stdout


def _sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        if "_build" in root or "__pycache__" in root:
            continue
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    return files


def test_sources_name_no_jax_import():
    files = _sources()
    assert len(files) > 15
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|flax|jaxlib|particlemethod_fsi_tpu)(\.|\s|$)",
        re.M)
    for f in files:
        with open(f) as fh:
            text = fh.read()
        assert not pat.search(text), f


def test_kernel_sources_and_loader_need_no_compiler_at_import():
    """The build happens at first launch, not at import; with no nvcc the
    loader raises (it never falls back)."""
    from particlemethod_fsi_tpu_torch.ops import cuda_loader

    cu = sorted(p.name for p in cuda_loader.CSRC_DIR.glob("*.cu"))
    assert cu == ["bf16_microbench.cu", "phase1_sweep.cu", "phase2_sweep.cu",
                  "virial_sweep.cu"]
    # every kernel's C entry point, kernels 1-7
    text = " ".join(p.read_text() for p in cuda_loader.CSRC_DIR.glob("*.cu"))
    for entry in ("fsi_phase1_sweep", "fsi_phase2_sweep", "fsi_virial_sweep",
                  "fsi_phase1_rows", "fsi_phase2_rows", "fsi_virial_rows",
                  "fsi_bf16_microbench"):
        assert f'extern "C" int {entry}(' in text, entry
    for p in cuda_loader.CSRC_DIR.glob("*.cu"):
        text = p.read_text()
        assert 'extern "C"' in text and "torch/" not in text
    assert "-use_fast_math" not in " ".join(cuda_loader.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in cuda_loader.NVCC_FLAGS
    try:
        cuda_loader._find_nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError):
            cuda_loader.load()
