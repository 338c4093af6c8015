"""ctypes bindings to the native IO/runtime library (native/snmfio.cpp).

The port's own copy of the reference package's ``io/native.py``: the same
C source, entry points and NumPy fallbacks, held statement for statement
equal to the reference outside its paths and its build function by
tests/test_torch_io.py.  The library is compiled on first use with the
system g++ (the flags of ``native/Makefile``) into ``build/native/``, never
into ``native/``.  Every entry point has a NumPy fallback (the port's own
copies of the Python paths) so the package works without a compiler;
``native_available()`` reports which path is active.  A host library: no
tensor and no device is involved.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
_SOURCE = _ROOT / "native" / "snmfio.cpp"
_LIB_PATH = _ROOT / "build" / "native" / "libsnmfio.so"
_lib = None
_tried = False


def _build() -> bool:
    """Compile ``native/snmfio.cpp`` with the flags of ``native/Makefile``
    into ``_LIB_PATH`` (under ``build/``, never beside the source)."""
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.stem}.{os.getpid()}.tmp.so")
    try:
        _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-shared",
                        "-std=c++17", "-Wall", "-o", str(tmp), str(_SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)      # whole, even beside another build
        return _LIB_PATH.exists()
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_int16_p = ctypes.POINTER(ctypes.c_int16)
    lib.quantize_int16.argtypes = [c_double_p, c_int16_p, ctypes.c_int64]
    lib.wavwrite_quantize.argtypes = [c_double_p, c_int16_p, ctypes.c_int64]
    lib.frame_stream.argtypes = [c_double_p, ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, c_double_p]
    lib.frame_stream.restype = ctypes.c_int64
    lib.overlap_add.argtypes = [c_double_p, ctypes.c_int64, ctypes.c_int,
                                ctypes.c_int, c_double_p]
    lib.wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
                             ctypes.POINTER(ctypes.c_int32),
                             ctypes.POINTER(ctypes.c_int64)]
    lib.wav_info.restype = ctypes.c_int
    lib.wav_read_int16.argtypes = [ctypes.c_char_p, c_double_p]
    lib.wav_read_int16.restype = ctypes.c_int
    lib.wav_write_int16.argtypes = [ctypes.c_char_p, c_int16_p,
                                    ctypes.c_int64, ctypes.c_int32,
                                    ctypes.c_int32]
    lib.wav_write_int16.restype = ctypes.c_int
    lib.wav_write_enhanced.argtypes = [ctypes.c_char_p, c_double_p,
                                       ctypes.c_int64, ctypes.c_int32]
    lib.wav_write_enhanced.restype = ctypes.c_int
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def quantize_int16(x: np.ndarray) -> np.ndarray:
    """MATLAB fwrite int16 semantics (native path of matlab_int16_write)."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float64)
    if lib is None:
        from se_snmf_nat_tpu_torch.utils.matlab_compat import (
            matlab_int16_write)
        return matlab_int16_write(x)
    out = np.empty(x.shape, np.int16)
    lib.quantize_int16(_dp(x), _ip(out), x.size)
    return out


def frame_stream(x: np.ndarray, framelength: int, frameshift: int,
                 n_flush: int) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, np.float64).reshape(-1)
    if lib is None:
        from se_snmf_nat_tpu_torch.dsp.stft import stream_frames
        return stream_frames(x, framelength, frameshift, n_flush)
    t = len(x) // frameshift + n_flush
    out = np.empty((t, framelength), np.float64)
    lib.frame_stream(_dp(x), len(x), framelength, frameshift, n_flush,
                     _dp(out))
    return out


def overlap_add(frames: np.ndarray, frameshift: int) -> np.ndarray:
    lib = _load()
    frames = np.ascontiguousarray(frames, np.float64)
    t, n = frames.shape
    if lib is None:
        acc = np.zeros((t - 1) * frameshift + n)
        for i in range(t):
            acc[i * frameshift: i * frameshift + n] += frames[i]
        return acc
    out = np.empty((t - 1) * frameshift + n, np.float64)
    lib.overlap_add(_dp(frames), t, n, frameshift, _dp(out))
    return out


def read_wav_int16(path) -> tuple[np.ndarray, int]:
    lib = _load()
    if lib is None:
        from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16 as py_read
        return py_read(path)
    fs = ctypes.c_int32()
    ch = ctypes.c_int32()
    n = ctypes.c_int64()
    rc = lib.wav_info(str(path).encode(), ctypes.byref(fs), ctypes.byref(ch),
                      ctypes.byref(n))
    if rc == 2:   # unsupported format: same exception type as the pure-
        #           Python fallback so callers can catch one class
        raise ValueError(f"{path}: expected 16-bit PCM")
    if rc:
        raise OSError(f"wav_info({path}) failed rc={rc}")
    out = np.empty(n.value * ch.value, np.float64)
    rc = lib.wav_read_int16(str(path).encode(), _dp(out))
    if rc:
        raise OSError(f"wav_read_int16({path}) failed rc={rc}")
    if ch.value > 1:
        out = out.reshape(-1, ch.value).T.copy()
    return out, fs.value


def write_wav_int16(path, samples_int16: np.ndarray, fs: int) -> None:
    lib = _load()
    x = np.ascontiguousarray(samples_int16)
    if x.dtype != np.int16:
        raise ValueError("expected int16 samples")
    if lib is None:
        from se_snmf_nat_tpu_torch.io.wavio import write_wav_int16 as py_write
        return py_write(path, x, fs)
    nch = 1 if x.ndim == 1 else x.shape[0]
    inter = x if x.ndim == 1 else np.ascontiguousarray(x.T).reshape(-1)
    rc = lib.wav_write_int16(str(path).encode(), _ip(inter),
                             inter.size // nch, fs, nch)
    if rc:
        raise OSError(f"wav_write_int16({path}) failed rc={rc}")


def write_enhanced_wav(path, samples: np.ndarray, fs: int) -> None:
    """Reference output chain (fwrite int16 -> pcm2wav) in one native call."""
    lib = _load()
    x = np.ascontiguousarray(samples, np.float64).reshape(-1)
    if lib is None:
        from se_snmf_nat_tpu_torch.io.wavio import (
            write_enhanced_wav as py_write)
        return py_write(path, x, fs)
    rc = lib.wav_write_enhanced(str(path).encode(), _dp(x), len(x), fs)
    if rc:
        raise OSError(f"wav_write_enhanced({path}) failed rc={rc}")
