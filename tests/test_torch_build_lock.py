"""The kernel build under a lock (``ops/_build.py``), on the CPU with a stub
``nvcc``: two processes that find the libraries missing at once (the ranks
of a data-parallel run) compile each library once, and both load the
result."""

import os
import subprocess
import sys
import textwrap

from indonesian_image_captioning_tpu_torch.ops import _build
from _torch_tmp import tmp_path  # noqa: F401 (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_processes_build_each_library_once(tmp_path):
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    # the stub writes its -o file after a pause, so both processes start
    # while nothing is built
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys, time
        out = sys.argv[sys.argv.index("-o") + 1]
        with open({str(calls)!r}, "a") as f:
            f.write(sys.argv[-1] + "\\n")
        time.sleep(0.5)
        open(out, "w").close()
        """))
    nvcc.chmod(0o755)
    script = textwrap.dedent(f"""\
        import sys, time
        from pathlib import Path
        sys.path.insert(0, {REPO!r})
        from indonesian_image_captioning_tpu_torch.ops import _build
        _build.BUILD_DIR = Path({str(tmp_path / "build")!r})
        _build._nvcc = lambda: {str(nvcc)!r}
        time.sleep(float(sys.argv[1]))
        _build._build_missing()
        assert not _build._missing()
        """)
    procs = [subprocess.Popen([sys.executable, "-c", script, delay])
             for delay in ("0", "0.1")]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    built = calls.read_text().split()
    sources = sorted(f"{n}.cu" for n in _build.SIGNATURES)
    assert sorted(os.path.basename(b) for b in built) == sources
    assert (tmp_path / "build" / "build.lock").exists()
