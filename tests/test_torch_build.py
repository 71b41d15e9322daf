"""The kernel build when processes start together (the ranks of a sharded
model on one host): `tpuserve_torch.kernels.build()` holds a lock on a file
in the build directory around its check-and-build, so of two processes that
race it one compiles and the other finds its library. Runs with a stub
`nvcc` (no CUDA toolkit needed): it records each call, sleeps so that the
two processes overlap, and writes the file it is asked for."""

import os
import stat
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STUB = textwrap.dedent("""\
    #!{python}
    import os, sys, time
    with open({calls!r}, "a") as fh:
        fh.write(" ".join(sys.argv[1:]) + "\\n")
    time.sleep(0.5)
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(out, "w") as fh:
        fh.write("stub")
    """)

RACE = textwrap.dedent("""\
    import sys
    from pathlib import Path
    import tpuserve_torch.kernels as k
    k.BUILD_DIR = Path(sys.argv[1])
    print(k.build().path)
    """)


def test_processes_that_build_together_share_one_library(tmp_path):
    bin_dir, build_dir = tmp_path / "bin", tmp_path / "build"
    bin_dir.mkdir()
    calls = tmp_path / "calls.txt"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(STUB.format(python=sys.executable, calls=str(calls)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}",
               PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", RACE, str(build_dir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    libs = [f for f in os.listdir(build_dir) if f.endswith(".so")]
    assert libs == [os.path.basename(paths.pop())]
    from tpuserve_torch import kernels

    lines = calls.read_text().splitlines()
    assert len(lines) == len(kernels.SOURCES) + 1            # one build: each source, one link
    assert sum("-shared" in ln for ln in lines) == 1
    assert not [f for f in os.listdir(build_dir) if ".tmp" in f]
