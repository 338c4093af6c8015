"""In-process microphone capture (optional).

The port's own copy of the reference package's ``io/capture.py``, held
statement for statement equal to it by tests/test_torch_io.py (its error
message names the reference package's CLI, the only CLI so far).

The reference GUI grabs the mic in-process via MATLAB's DSP toolbox
(``dsp.AudioRecorder``, SE_GUI.m:374 and src/func/dsp_record.m:3-13).  The
default capture path stays device-independent: raw int16 PCM from stdin,
so any OS tool (arecord, sox, ffmpeg) is the microphone.  This module adds
the in-process equivalent behind an optional dependency (``sounddevice`` /
PortAudio), imported at call time: environments without it get a clear
error pointing at the stdin path.
"""

from __future__ import annotations

import numpy as np


def have_sounddevice() -> bool:
    try:
        import sounddevice  # noqa: F401
        return True
    except Exception:
        return False


def mic_hops(fs: int, hop: int, *, _stream_factory=None):
    """Yield ``(hop,)`` float64 int16-scale sample blocks from the default
    input device until the stream errors or the consumer stops.

    ``_stream_factory``: test seam — a zero-arg callable returning a
    context manager with ``read(n) -> (int16 array (n, channels),
    overflowed)`` (the sounddevice.InputStream contract).
    """
    if _stream_factory is None:
        try:
            import sounddevice as sd
        except ImportError as e:
            raise RuntimeError(
                "in-process capture needs the optional 'sounddevice' "
                "package (PortAudio). Use the device-independent stdin "
                "path instead: arecord -f S16_LE -r 16000 -c 1 | "
                "python -m se_snmf_nat_tpu demo -") from e

        def _stream_factory():
            return sd.InputStream(samplerate=fs, channels=1, dtype="int16")

    with _stream_factory() as stream:
        while True:
            data, _overflowed = stream.read(hop)
            block = np.asarray(data)
            if block.ndim == 2:
                block = block[:, 0]
            if block.shape[0] < hop:
                return
            yield block.astype(np.float64)
