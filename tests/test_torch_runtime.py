"""The port's kernel build: nvcc flags, hash-named libraries, parallel
builds and their failure reports — checked on the CPU with a stand-in
compiler, since nvcc runs only where the card is."""

import os
import re
import stat

import pytest

from outerspace_tpu_torch.ops.kernels import compact, expand, gexpand, loop_expand, scan, spmm
from outerspace_tpu_torch.runtime import build

KERNELS = (gexpand.KERNEL, scan.KERNEL, expand.KERNEL_PACKED, expand.KERNEL_COORDS, spmm.KERNEL,
           compact.KERNEL, loop_expand.KERNEL, loop_expand.KERNEL_64)


def test_nvcc_flags_target_hopper_without_torch_headers():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    for f in ("-shared", "-fPIC", "-O3", "-std=c++17"):
        assert f in flags
    for name in build.KERNEL_SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        assert "torch/extension.h" not in src
        assert 'extern "C" const char* cuda_error_string(' in src
    assert {k.source for k in KERNELS} == set(build.KERNEL_SOURCES)
    for kernel in KERNELS:
        src = (build.CSRC / f"{kernel.source}.cu").read_text()
        assert f'extern "C" int {kernel.symbol}(' in src


def test_library_path_tracks_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// v1\n")
    p1 = build.library_path("k")
    assert p1.parent == build.BUILD_DIR and p1.name.startswith("libk-")
    assert build.library_path("k") == p1
    (tmp_path / "k.cu").write_text("// v2\n")
    p2 = build.library_path("k")
    assert p2 != p1
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("k") != p2


def fake_nvcc(tmp_path, fail_on=None):
    """A stand-in compiler: writes its -o target, or fails on one source."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        'out=""; src=""\n'
        'while [ $# -gt 0 ]; do case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac; shift; done\n'
        f'case "$src" in *{fail_on or "@none@"}.cu) echo "error: bad source $src"; exit 2;; esac\n'
        'echo "ptxas info    : Used 8 registers"; echo lib > "$out"\n'
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_build_compiles_missing_libraries_once(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    nvcc = fake_nvcc(tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: nvcc)
    reports = build.build()
    assert set(reports) == set(build.KERNEL_SOURCES)
    assert all("registers" in log for log in reports.values())
    for name in build.KERNEL_SOURCES:
        assert build.library_path(name).exists()
    assert not [p for p in os.listdir(tmp_path / "build") if p.endswith(".tmp")]
    assert build.build() == {}  # nothing to rebuild


def test_build_reports_compiler_errors(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    nvcc = fake_nvcc(tmp_path, fail_on="scan")
    monkeypatch.setattr(build, "nvcc_path", lambda: nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed on scan.cu:\n.*bad source"):
        build.build()
    assert build.library_path("gexpand").exists()
    assert not build.library_path("scan").exists()


def test_kernels_load_lazily_and_count_launches():
    for kernel in KERNELS:
        assert isinstance(kernel, build.CudaKernel)
        assert kernel._fn is None  # nothing built or loaded at import
        assert kernel.launches == 0


def test_scan_wrapper_sizes_match_the_kernel():
    # the wrapper allocates K2's tile records for csrc/scan.cu's tiles
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", (build.CSRC / "scan.cu").read_text()))
    assert scan.TILE == int(const["kThreads"]) * int(const["kPer"])
    assert scan._REC_FIELDS == int(const["kRecFields"])
