"""``kernels/build.py::build`` compiles once when several processes ask for
the same library at once, as the ranks of a process-a-card run do when
they start cold: the build holds a ``flock`` on a lock file beside the
library, and a process that waited for it loads what the first one built.

A stand-in compiler (a script that appends its sources to a count file,
sleeps and writes its ``-o`` output) takes ``nvcc``'s place, since this
machine has none; two processes, released together, call ``build()`` into
one build directory.
"""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import os
import stat
import sys

from aslr_to_tpu_torch.kernels import build
from aslr_to_tpu_torch.parallel import launch

FAKE_NVCC = """#!{python}
import sys, time
argv = sys.argv[1:]
with open({count!r}, "a") as f:
    f.write(" ".join(a for a in argv if a.endswith(".cu")) or "link")
    f.write("\\n")
time.sleep(1.0)
with open(argv[argv.index("-o") + 1], "wb") as f:
    f.write(b"stand-in")
"""

CALLER = """
import sys
from pathlib import Path
from aslr_to_tpu_torch.kernels import build
build.BUILD_DIR = Path(sys.argv[1])
build._nvcc = lambda: sys.argv[2]
print("ready", flush=True)
sys.stdin.readline()
print("built", build.build().name, flush=True)
"""


def test_two_processes_that_build_at_once_compile_once(tmp_path):
    count = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, count=str(count)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    out = tmp_path / "build"
    with launch.Ranks(2, ["-c", CALLER, str(out), str(nvcc)], timeout=120,
                      stdin=True) as procs:
        procs.wait_for("ready")
        procs.send("go\n")
        texts = procs.wait()
    lib = build.library_path().name
    assert [t.splitlines()[-1] for t in texts] == [f"built {lib}"] * 2, texts
    calls = count.read_text().splitlines()
    cus, _ = build._sources()
    # one build: an nvcc a source and the link, not two of each
    assert sorted(calls) == sorted([str(cu) for cu in cus] + ["link"]), calls
    assert (out / lib).read_bytes() == b"stand-in"
    assert sorted(os.listdir(out)) == sorted([lib, lib.removesuffix(".so") + ".lock"])
