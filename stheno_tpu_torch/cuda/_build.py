"""Build the CUDA sources in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface,
built for `sm_90a` at first use into `build/cuda/` at the root of the
checkout (listed in `.gitignore`), each nvcc spreading its kernels over
every core.  The library's file name carries a hash of
the source and the flags, so an edited source is rebuilt and a stale library
is never loaded.  `build()` starts one nvcc per missing library, all at once,
and waits for every one of them.  A failed build raises with nvcc's stderr;
nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # optimise a source's kernels in parallel, on every core (kernel 1's
    # source holds 272 template instances)
    "--split-compile=0",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
            "kernels of stheno_tpu_torch are built from source at first use"
        )
    return str(path)


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(*names: str) -> dict[str, Path]:
    """Build the named libraries that are missing, one nvcc each, in
    parallel.  Returns the path of every named library."""
    targets = {name: _target(name) for name in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{err}")
        else:
            os.replace(tmp, targets[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)[name]))
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point of `lib` returned a CUDA error code."""
    if code != 0:
        lib.stheno_error_string.restype = ctypes.c_char_p
        lib.stheno_error_string.argtypes = [ctypes.c_int]
        msg = lib.stheno_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


class LaunchCounter:
    """Counts the launches of one kernel, in total and by launch shape."""

    def __init__(self, name: str):
        self.name = name
        self.total = 0
        self.by_shape: dict[tuple, int] = {}

    def add(self, shape: tuple) -> None:
        self.total += 1
        self.by_shape[shape] = self.by_shape.get(shape, 0) + 1

    def reset(self) -> None:
        self.total = 0
        self.by_shape = {}
