"""The port's in-process mic capture (``io/capture.py``, a copy of the
reference package's), driven through its fake stream factory as the
reference package's tests drive the original."""

import contextlib

import numpy as np
import pytest

from se_snmf_nat_tpu_torch.io.capture import have_sounddevice, mic_hops


class _FakeStream:
    """sounddevice.InputStream contract: context manager + read(n)."""

    def __init__(self, blocks):
        self._blocks = list(blocks)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def read(self, n):
        if not self._blocks:
            return np.zeros((0, 1), np.int16), False
        b = self._blocks.pop(0)
        return b.reshape(-1, 1).astype(np.int16), False


def test_mic_hops_yields_float64_hops():
    blocks = [np.arange(160, dtype=np.int16) + i for i in range(3)]
    got = list(mic_hops(16000, 160,
                        _stream_factory=lambda: _FakeStream(blocks)))
    assert len(got) == 3
    for i, h in enumerate(got):
        assert h.dtype == np.float64 and h.shape == (160,)
        np.testing.assert_array_equal(h, blocks[i].astype(np.float64))


def test_mic_hops_stops_on_short_read():
    blocks = [np.zeros(160, np.int16), np.zeros(80, np.int16)]
    got = list(mic_hops(16000, 160,
                        _stream_factory=lambda: _FakeStream(blocks)))
    assert len(got) == 1


def test_mic_hops_clear_error_without_sounddevice():
    if have_sounddevice():  # pragma: no cover - not in this image
        pytest.skip("sounddevice present")
    with pytest.raises(RuntimeError, match="stdin"):
        with contextlib.closing(mic_hops(16000, 160)) as g:
            next(g)
