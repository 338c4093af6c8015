"""Build the CUDA sources of ``csrc/`` at first use and load them with
ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` compiles every ``csrc/*.cu`` (with the headers
``csrc/*.cuh`` they include) into one shared library with a plain C
interface, under ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``).  The library's name carries a hash of the sources, headers
and flags, so an edited source builds anew.  No fast math: the kernels'
relative-cost stop relies on IEEE inf/NaN and an accurate ``logf``.

Nothing is built when this module is imported; ``load()`` builds (once per
process) and raises if ``nvcc`` is missing or the build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entries (see the sources)
SIGNATURES = {
    "mu_h_solve_lanes": [_P, _P, _P, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _F, _F, _F, _P],
    "mu_h_solve_columns": [_P, _L, _L, _P, _P, _L, _L, _P, _L, _L, _P, _P, _P,
                           _P, _P, _I, _I, _I, _I, _F, _F, _F, _P],
    "mu_w_solve_lanes": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _F, _F, _F, _P],
}


class KernelLibrary:
    """The loaded library, its build log and how long the build took."""

    def __init__(self, path: Path, log: str, seconds: float):
        self.path = path
        self.log = log
        self.build_seconds = seconds
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


_LOADED: dict[str, KernelLibrary] = {}


def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library."""
    sources = _sources()
    digest = _digest(sources)
    hit = _LOADED.get(digest)
    if hit is not None:
        return hit
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libmu_kernels_{digest}.so"
    log_path = out.with_suffix(".log")
    t0 = time.perf_counter()
    if not out.exists():
        nvcc = _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log_path.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    seconds = time.perf_counter() - t0
    lib = KernelLibrary(out, log_path.read_text() if log_path.exists()
                        else "", seconds)
    _LOADED[digest] = lib
    return lib
