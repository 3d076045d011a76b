"""The port's kernel build helper (oisat_tpu_torch.ops.kernels._build) on the
CPU, with a stand-in for nvcc: the build flags target sm_90a, a failed build
raises with the compiler's output and leaves nothing behind, a good build is
written atomically with its ptxas log, and a newer source or header is
rebuilt."""

import os
import stat

import pytest

from oisat_tpu_torch.ops.kernels import _build

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "$NVCC_ARGS"
[ -n "$NVCC_FAIL" ] && { echo "k.cu(3): error: $NVCC_FAIL" >&2; exit 2; }
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
echo built > "$out"
echo "ptxas info    : Used 32 registers" >&2
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("loaded", path))
    monkeypatch.setenv("NVCC_ARGS", str(tmp_path / "args.txt"))
    monkeypatch.delenv("NVCC_FAIL", raising=False)
    return tmp_path


def test_failed_build_raises_with_nvcc_output(fake_toolchain, monkeypatch):
    monkeypatch.setenv("NVCC_FAIL", "identifier undefined")
    with pytest.raises(RuntimeError, match="identifier undefined"):
        _build.load_library("k")
    build = fake_toolchain / "build"
    assert not (build / "libk.so").exists()
    assert not list(build.glob("*.tmp"))


def test_build_targets_sm90a_keeps_log_and_rebuilds_newer_source(fake_toolchain, monkeypatch):
    lib = fake_toolchain / "build" / "libk.so"
    assert _build.load_library("k") == ("loaded", str(lib))
    args = (fake_toolchain / "args.txt").read_text().splitlines()
    assert len(args) == 1 and "arch=compute_90a,code=sm_90a" in args[0]
    assert "-shared" in args[0] and "-Xptxas -v" in args[0]
    assert "Used 32 registers" in _build.build_log("k")
    assert not list(lib.parent.glob("*.tmp"))

    # loaded once per process; a fresh process with an up-to-date library
    # does not rebuild, one whose source is newer does
    assert _build.load_library("k") == ("loaded", str(lib))
    monkeypatch.setattr(_build, "_loaded", {})
    _build.load_library("k")
    assert len((fake_toolchain / "args.txt").read_text().splitlines()) == 1
    src = fake_toolchain / "csrc" / "k.cu"
    later = lib.stat().st_mtime + 10
    os.utime(src, (later, later))
    monkeypatch.setattr(_build, "_loaded", {})
    _build.load_library("k")
    assert len((fake_toolchain / "args.txt").read_text().splitlines()) == 2
    # so does one with a newer header of csrc/ (ak_curve.cu includes fast_paths.cuh)
    header = fake_toolchain / "csrc" / "shared.cuh"
    header.write_text("// shared\n")
    later = lib.stat().st_mtime + 10
    os.utime(header, (later, later))
    monkeypatch.setattr(_build, "_loaded", {})
    _build.load_library("k")
    assert len((fake_toolchain / "args.txt").read_text().splitlines()) == 3


def test_concurrent_loads_build_each_library_once(fake_toolchain):
    """chip_smoke.py builds every kernel at once from several threads: each
    library is built exactly once and every caller gets the loaded one."""
    import sys
    import threading

    (fake_toolchain / "csrc" / "k2.cu").write_text("// kernel 2\n")
    got = []
    threads = [threading.Thread(target=lambda n=name: got.append((n, _build.load_library(n))))
               for name in ("k", "k2") * 12]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    args = (fake_toolchain / "args.txt").read_text().splitlines()
    assert sorted(a.split()[-1].rsplit("/", 1)[-1] for a in args) == ["k.cu", "k2.cu"]
    assert len(got) == 24
    for name, handle in got:
        assert handle == ("loaded", str(fake_toolchain / "build" / f"lib{name}.so"))
