"""Wav / raw-PCM int16 I/O with MATLAB-equivalent numerics.

The port's own copy of the reference package's module of the same name,
held equal to it statement for statement by tests/test_torch_io.py.

The reference streams wav files as *raw int16* after skipping a 44-byte
canonical header (22 int16 reads — filewise_run_IS16.m:92-97), writes raw
int16 hops with fwrite (:165), and finalizes by re-reading the raw stream,
dividing by 32767, and calling wavwrite (pcm2wav.m:3-11).  The double
quantization (fwrite rounds half-away + wavwrite rescales by 32768/32767)
is reproduced here because the committed golden outputs carry it.
"""

from __future__ import annotations

import struct
import wave
from pathlib import Path

import numpy as np

from se_snmf_nat_tpu_torch.utils.matlab_compat import (
    matlab_int16_write,
    matlab_wavwrite_quantize,
)


def read_wav_int16(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a 16-bit PCM wav; returns (float64 samples in int16 scale, fs).

    Matches the reference's raw-stream read: samples come back as doubles in
    [-32768, 32767] (MATLAB fread 'int16' yields doubles).
    """
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: expected 16-bit PCM")
        fs = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
        data = np.frombuffer(raw, dtype="<i2").astype(np.float64)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).T
    return data, fs


def read_wav_normalized(path: str | Path) -> tuple[np.ndarray, int]:
    """MATLAB wavread semantics: int16 / 32768 → float64 in [-1, 1)."""
    data, fs = read_wav_int16(path)
    return data / 32768.0, fs


def write_wav_int16(path: str | Path, samples_int16: np.ndarray, fs: int) -> None:
    """Write int16 samples as a canonical 44-byte-header mono/stereo wav."""
    x = np.asarray(samples_int16)
    if x.dtype != np.int16:
        raise ValueError("write_wav_int16 expects int16 samples")
    nch = 1 if x.ndim == 1 else x.shape[0]
    if x.ndim > 1:
        x = x.T.reshape(-1)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(nch)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(x.astype("<i2").tobytes())


def write_enhanced_wav(path: str | Path, samples: np.ndarray, fs: int) -> None:
    """Reproduce the reference's output chain exactly:

    1. fwrite(..., 'int16') of the float hop samples — round half-away from
       zero, saturate (filewise_run_IS16.m:165);
    2. pcm2wav: reload, divide by 32767, wavwrite 16-bit which quantizes by
       round(x*32768) (pcm2wav.m:9-10).
    """
    pcm = matlab_int16_write(samples)
    rescaled = matlab_wavwrite_quantize(pcm.astype(np.float64) / 32767.0)
    write_wav_int16(path, rescaled, fs)


def enhanced_quantize(samples: np.ndarray) -> np.ndarray:
    """The int16 values write_enhanced_wav would store (for comparisons)."""
    pcm = matlab_int16_write(samples)
    return matlab_wavwrite_quantize(pcm.astype(np.float64) / 32767.0)


def raw_pcm_header_skip_bytes() -> int:
    """The reference skips 22 int16 = 44 bytes (filewise_run_IS16.m:95)."""
    return 44


def parse_wav_header(path: str | Path) -> dict:
    """Minimal canonical-header parse (debug/validation helper)."""
    with open(path, "rb") as f:
        hdr = f.read(44)
    riff, size, wavefmt = struct.unpack("<4sI4s", hdr[:12])
    return {"riff": riff, "size": size, "wave": wavefmt}
