"""Build the port's CUDA kernels with ``nvcc`` and its host libraries
(the planner core, the Matrix Market reader, the CPU reference SpGEMM,
the event model) with ``g++``, and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports plain C launchers (no PyTorch headers),
so one ``nvcc`` call builds it in seconds. Libraries go to ``build/`` at
the repository root, named by a hash of the source and the flags, so a
library is rebuilt only when its source changes. :func:`build` starts
one ``nvcc`` per missing library, all together, and waits for every one.

A :class:`CudaKernel` loads its library on first launch (building it if
needed), checks the launcher's returned ``cudaError_t`` and counts its
launches. :func:`host_library` builds and loads a plain C++ source
(``csrc/<name>.cpp``, no CUDA) the same way; the CPU has one too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
KERNEL_SOURCES = ("gexpand", "scan", "expand", "spmm", "prune_compact", "loop_expand")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
HOST_SOURCES = ("gplan", "mtx_reader", "ref_spgemm", "perfsim")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Build every library in ``names`` that is missing, one ``nvcc``
    process per source, all started together. Returns each built
    library's ``ptxas`` report (registers, shared memory, spills);
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, out)
    reports, failures = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failures.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def host_library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cpp`` lives."""
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
    """Build ``csrc/<name>.cpp`` with the host's ``g++`` unless its
    library exists; raises with the compiler's output if the build
    fails."""
    out = host_library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"g++ failed on {name}.cpp:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


_HOST_LIBRARIES: dict[str, ctypes.CDLL] = {}


def host_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cpp``, built at first use."""
    lib = _HOST_LIBRARIES.get(name)
    if lib is None:
        lib = _HOST_LIBRARIES[name] = ctypes.CDLL(str(build_host(name)))
    return lib


def tensor_ptr(t) -> ctypes.c_void_p:
    """A tensor's device address as a pointer argument (a plain int
    would be cut to 32 bits by ctypes)."""
    return ctypes.c_void_p(t.data_ptr())


def device_args(device) -> tuple[int, ctypes.c_void_p]:
    """A CUDA device's index and PyTorch's current stream on it, as the
    launchers' last two arguments."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, ctypes.c_void_p(torch.cuda.current_stream(index).cuda_stream)


class CudaKernel:
    """One exported launcher of a ``csrc/*.cu`` library.

    The library is loaded (and built if missing) on the first launch,
    never at import. ``launches`` counts successful launches; callers
    may reset it to 0.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._lib = None

    def _load(self):
        path = library_path(self.source)
        if not path.exists():
            build([self.source])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        self._lib, self._fn = lib, fn

    def launch(self, *args) -> None:
        if self._fn is None:
            self._load()
        err = self._fn(*args)
        if err:
            msg = self._lib.cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1
