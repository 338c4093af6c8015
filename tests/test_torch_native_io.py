"""The port's native IO library (``io/native.py``: ctypes over
``native/snmfio.cpp``) against the reference package's and against the
port's own Python paths.  The library is built once for this module into a
temporary directory (never into ``native/``); the NumPy fallbacks are
checked too.  Nothing here reads a file the tests did not write."""

import struct

import numpy as np
import pytest

from se_snmf_nat_tpu.io import native as j_native
from se_snmf_nat_tpu_torch.dsp.stft import stream_frames
from se_snmf_nat_tpu_torch.io import native
from se_snmf_nat_tpu_torch.io.wavio import (
    enhanced_quantize, read_wav_int16, write_enhanced_wav, write_wav_int16)
from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_int16_write

NATIVE_DIR = native._SOURCE.parent


def _listing():
    return sorted((p.name, p.stat().st_mtime_ns)
                  for p in NATIVE_DIR.iterdir())


@pytest.fixture(scope="module", params=["library", "fallback"])
def lib(request, tmp_path_factory):
    """The module's entry points on the library built into a temporary
    directory, then on the NumPy fallbacks."""
    saved = native._LIB_PATH, native._lib, native._tried
    before = _listing()
    native._LIB_PATH = tmp_path_factory.mktemp("native") / "libsnmfio.so"
    native._lib, native._tried = None, request.param == "fallback"
    if request.param == "library":
        if not native.native_available():
            pytest.skip("no C++ toolchain")
        assert native._LIB_PATH.exists()
        assert _listing() == before            # nothing written in native/
    else:
        assert not native.native_available()
    yield request.param
    native._LIB_PATH, native._lib, native._tried = saved


def test_quantize_matches_matlab_and_reference(lib):
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(10000) * 20000,
        [0.5, -0.5, 1.5, -1.5, 32767.4, 32767.6, -32768.4, -32768.6,
         0.49999999, -0.49999999]])
    got = native.quantize_int16(x)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, matlab_int16_write(x))
    np.testing.assert_array_equal(got, j_native.quantize_int16(x))


def test_frame_stream_matches_python_and_reference(lib):
    x = np.random.default_rng(1).standard_normal(16013) * 1000
    got = native.frame_stream(x, 640, 160, 4)
    np.testing.assert_array_equal(got, stream_frames(x, 640, 160, n_flush=4))
    np.testing.assert_array_equal(got, j_native.frame_stream(x, 640, 160, 4))


def test_overlap_add_matches_python_and_reference(lib):
    frames = np.random.default_rng(2).standard_normal((37, 640))
    acc = np.zeros(36 * 160 + 640)
    for i in range(37):
        acc[i * 160: i * 160 + 640] += frames[i]
    got = native.overlap_add(frames, 160)
    np.testing.assert_array_equal(got, acc)
    np.testing.assert_array_equal(got, j_native.overlap_add(frames, 160))


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_round_trip_matches_python_and_reference(lib, tmp_path,
                                                     channels):
    rng = np.random.default_rng(3)
    shape = (channels, 4321) if channels > 1 else 12345
    x = (rng.standard_normal(shape) * 9000).astype(np.int16)
    native.write_wav_int16(tmp_path / "n.wav", x, 16000)
    write_wav_int16(tmp_path / "p.wav", x, 16000)
    j_native.write_wav_int16(tmp_path / "r.wav", x, 16000)
    data = (tmp_path / "n.wav").read_bytes()
    assert data == (tmp_path / "p.wav").read_bytes() \
        == (tmp_path / "r.wav").read_bytes()
    got, fs = native.read_wav_int16(tmp_path / "p.wav")
    want, fs_p = read_wav_int16(tmp_path / "n.wav")
    assert fs == fs_p == 16000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.astype(np.float64))
    with pytest.raises(ValueError):
        native.write_wav_int16(tmp_path / "f.wav", x.astype(np.float64),
                               16000)


def test_enhanced_write_chain(lib, tmp_path):
    y = np.random.default_rng(4).standard_normal(8000) * 15000
    native.write_enhanced_wav(tmp_path / "n.wav", y, 16000)
    write_enhanced_wav(tmp_path / "p.wav", y, 16000)
    assert (tmp_path / "n.wav").read_bytes() \
        == (tmp_path / "p.wav").read_bytes()
    got, _ = native.read_wav_int16(tmp_path / "n.wav")
    np.testing.assert_array_equal(got.astype(np.int16), enhanced_quantize(y))


def test_malformed_multichannel_data_chunk_no_overflow(lib, tmp_path):
    """A stereo wav whose data-chunk byte size is not a multiple of
    2*channels reads its whole frames only (the reference's heap-overflow
    gate of the native reader)."""
    p = tmp_path / "bad.wav"
    data = struct.pack("<3h", 100, -200, 300)       # 6 bytes, ch=2 -> 1 frame
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
           + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, 16000,
                                   64000, 4, 16)
           + b"data" + struct.pack("<I", len(data)))
    p.write_bytes(hdr + data)
    x, fs = native.read_wav_int16(p)
    assert fs == 16000 and x.shape == (2, 1)
    np.testing.assert_array_equal(x, [[100.0], [-200.0]])


def test_unsupported_format_raises_value_error(lib, tmp_path):
    import wave
    with wave.open(str(tmp_path / "w8.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(1)
        w.setframerate(16000)
        w.writeframes(bytes(10))
    with pytest.raises(ValueError):
        native.read_wav_int16(tmp_path / "w8.wav")
