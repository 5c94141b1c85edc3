"""The port's kernel builder (`repro_torch.kernels._build`) on the CPU,
with a stand-in `nvcc` on PATH: a build runs the compiler once, a second
build of the same source reuses the library and still reports what the
compiler printed (ptxas's registers and spills), and an edited source
builds anew."""
import os
import stat

import pytest

from repro_torch.kernels import _build

FAKE_NVCC = """#!/bin/sh
# stand-in nvcc: write the -o file, print one ptxas line per call
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
echo built > "$out"
echo "ptxas info    : Used 40 registers, used 1 barriers, 4096 bytes smem" >&2
echo call >> "$(dirname "$out")/calls"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}"
                       f"{os.environ.get('PATH', '')}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_reused_build_reports_the_compiler_log(fake_nvcc):
    source = fake_nvcc / "k.cu"
    source.write_text("// kernel\n")
    first = _build.build(source, "k")
    assert first.path.exists() and first.seconds > 0.0
    assert "Used 40 registers" in first.log
    again = _build.build(source, "k")
    assert again.path == first.path and again.seconds == 0.0
    assert again.log == first.log
    assert (fake_nvcc / "build" / "calls").read_text().count("call") == 1
    source.write_text("// kernel, edited\n")
    edited = _build.build(source, "k")
    assert edited.path != first.path and "Used 40 registers" in edited.log
    assert (fake_nvcc / "build" / "calls").read_text().count("call") == 2
