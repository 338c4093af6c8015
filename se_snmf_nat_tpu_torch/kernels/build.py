"""Build the CUDA sources of ``csrc/`` at first use and load them with
ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
-fPIC -c`` compiles every ``csrc/*.cu`` (with the headers ``csrc/*.cuh``
they include), one ``nvcc`` per source, all started together, and
``nvcc -shared`` links them into one shared library with a plain C
interface, under ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``).  The library's name carries a hash of the sources, headers
and flags, so a process that finds an edited source builds anew.  No fast
math: the kernels' relative-cost stop relies on IEEE inf/NaN and an
accurate ``logf``.

Nothing is built when this module is imported; ``load()`` builds and loads
(once per process) and raises if ``nvcc`` is missing or the build fails.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entries (see the sources)
SIGNATURES = {
    "mu_h_solve_lanes": [_P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                         _F, _P],
    "mu_h_solve_lanes_shape": [_I, _I, _I, _I, _P],
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


_LIB: KernelLibrary | None = None


def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library, once per process: the
    wrappers call this on every launch, so later calls return the loaded
    library without hashing the sources again."""
    global _LIB
    if _LIB is not None:
        return _LIB
    sources = _sources()
    digest = _digest(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libmu_kernels_{digest}.so"
    log_path = out.with_suffix(".log")
    t0 = time.perf_counter()
    if not out.exists():
        nvcc = _nvcc()
        tmp_dir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        try:
            objs = [tmp_dir / f"{src.stem}.o" for src in sources]
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources, objs)]
            logs = [p.communicate()[0] for p in procs]
            log = "".join(f"== {src.name}\n{text}"
                          for src, text in zip(sources, logs))
            rcs = [p.returncode for p in procs]
            if not any(rcs):
                link = subprocess.run(
                    [nvcc, "-shared", "-o", str(tmp_dir / out.name),
                     *map(str, objs)], capture_output=True, text=True)
                log += link.stdout + link.stderr
                rcs.append(link.returncode)
            log_path.write_text(log)
            if any(rcs):
                raise RuntimeError(f"nvcc failed ({rcs}):\n{log}")
            os.replace(tmp_dir / out.name, out)
        finally:
            shutil.rmtree(tmp_dir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    _LIB = KernelLibrary(out, log_path.read_text() if log_path.exists()
                         else "", seconds)
    return _LIB
