"""The port's native builds are safe when several processes build at once
(the ranks of a multi-device run that find no library): the CUDA kernels'
(``ops/cuda_loader``) and the IO runtime's (``io/native``).  No compiler is
needed: a stub stands in for ``nvcc`` and ``g++``.  It opens each output it
writes exclusively (a second writer of one path fails) and writes it in
two halves a moment apart, so two builds that shared a file would fail or
leave it torn.  Two processes start their build together, into one
directory; both must succeed, and the library must be whole."""

import os
import subprocess
import sys
import textwrap
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STUB = textwrap.dedent("""
    import os, sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    with open(out, "x") as f:
        if "-c" in args:
            f.write("obj " + os.path.basename(args[args.index("-c") + 1]))
            f.flush()
            time.sleep(0.3)
            f.write(" end\\n")
        else:
            parts = [open(a).read() for a in args if a.endswith(".o")]
            if not parts:  # the IO runtime: one source, no objects
                parts = ["lib " + os.path.basename(args[-1]) + " end\\n"]
            f.write(parts[0])
            f.flush()
            time.sleep(0.3)
            f.write("".join(parts[1:]))
    print("ptxas info    : Used 1 registers")
""")


def _stub(tmp_path, name):
    path = tmp_path / "bin" / name
    path.parent.mkdir(exist_ok=True)
    path.write_text(f"#!{sys.executable}\n" + STUB)
    path.chmod(0o755)
    return path


def _race(tmp_path, body: str, env=None):
    """Run ``body`` in two processes that start it together; their
    outputs."""
    go = tmp_path / "go"
    code = textwrap.dedent(f"""
        import os, sys, time
        from pathlib import Path
        from particlemethod_fsi_tpu_torch.io import native
        from particlemethod_fsi_tpu_torch.ops import cuda_loader
        Path({str(tmp_path)!r}, f"ready{{os.getpid()}}").write_text("")
        while not os.path.exists({str(go)!r}):
            time.sleep(0.01)
    """) + textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    deadline = time.monotonic() + 60
    while (len(list(tmp_path.glob("ready*"))) < 2
           and time.monotonic() < deadline):
        time.sleep(0.01)
    go.write_text("")
    outs = [p.communicate(timeout=60) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    return [o for o, _ in outs]


def test_two_kernel_builds_at_once_share_no_file(tmp_path):
    stub = _stub(tmp_path, "nvcc")
    out_dir = tmp_path / "build"
    _race(tmp_path, f"""
        srcs = sorted(cuda_loader.CSRC_DIR.glob("*.cu"))
        lib = cuda_loader._build(srcs, Path({str(out_dir)!r}), ())
        print(lib)
    """, env=dict(PATH=f"{stub.parent}{os.pathsep}{os.environ['PATH']}"))
    from particlemethod_fsi_tpu_torch.ops import cuda_loader

    names = sorted(p.name for p in cuda_loader.CSRC_DIR.glob("*.cu"))
    lib = (out_dir / cuda_loader.LIB_NAME).read_text()
    assert lib == "".join(f"obj {n} end\n" for n in names)
    assert "Used 1 registers" in (out_dir / "build.log").read_text()
    # nothing of either process's work is left beside the library
    assert sorted(os.listdir(out_dir)) == ["build.log", cuda_loader.LIB_NAME]


def test_two_io_runtime_builds_at_once_share_no_file(tmp_path):
    stub = _stub(tmp_path, "cxx")
    out_dir = tmp_path / "build"
    _race(tmp_path, f"""
        print(native._compile([{str(stub)!r}], Path({str(out_dir)!r})))
    """)
    from particlemethod_fsi_tpu_torch.io import native

    assert (out_dir / native.LIB_NAME).read_text() == "lib fsiio.cpp end\n"
    assert os.listdir(out_dir) == [native.LIB_NAME]
