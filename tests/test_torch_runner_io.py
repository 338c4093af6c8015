"""The directory runner's batch-plan I/O on the CPU: ``read_wav_pcm16``
gives what ``io/native``'s ``read_wav_int16`` gives (as int16 in the
caller's buffer for a mono 16-bit PCM file, through ``read_wav_int16``
itself for any other), and the batch plan's I/O thread: every file written
with its own chunk's output while the read buffers are reused, the next
chunk read while the enhancer runs the current one, and the stages' spans
and the file counter recorded in the calling thread's profiled session."""

import contextlib
import struct
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from se_snmf_nat_tpu_torch.io.native import read_wav_int16
from se_snmf_nat_tpu_torch.io.wavio import write_wav_int16
from se_snmf_nat_tpu_torch.runtime import profiling, runner
from se_snmf_nat_tpu_torch.runtime.profiling import span
from se_snmf_nat_tpu_torch.runtime.runner import BatchRunner, read_wav_pcm16

FS = 16000


def _wav(fmt=1, ch=1, bits=16, extra=b"", data=None, data_bytes=None):
    """A RIFF/WAVE file's bytes: ``extra`` chunks between "fmt " and
    "data"; ``data_bytes`` the data chunk's stated size."""
    data = np.arange(-700, 701, 7, dtype="<i2").tobytes() \
        if data is None else data
    size = len(data) if data_bytes is None else data_bytes
    fmt_chunk = struct.pack("<HHIIHH", fmt, ch, FS, FS * ch * bits // 8,
                            ch * bits // 8, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt_chunk + extra
            + b"data" + struct.pack("<I", size) + data)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _chunk(cid, payload):
    return cid + struct.pack("<I", len(payload)) + payload \
        + b"\0" * (len(payload) & 1)


@pytest.mark.parametrize("case", [
    "canonical", "list_chunk_odd", "no_samples", "odd_data_bytes"])
def test_pcm16_read_is_int16_in_the_buffer(tmp_path, case):
    blob = {"canonical": lambda: _wav(),
            "list_chunk_odd": lambda: _wav(extra=_chunk(b"LIST", b"abc")),
            "no_samples": lambda: _wav(data=b""),
            "odd_data_bytes": lambda: _wav(data=b"\1\2\3\4\5")}[case]()
    path = tmp_path / "a.wav"
    path.write_bytes(blob)
    buf = np.zeros(len(blob) + 1, np.uint8)
    x, fs = read_wav_pcm16(path, buf)
    want, want_fs = read_wav_int16(path)
    assert x.dtype == np.int16 and fs == want_fs == FS
    assert np.shares_memory(x, buf) or x.size == 0
    np.testing.assert_array_equal(x, want)


@pytest.mark.parametrize("case", [
    "stereo", "eight_bit", "float_format", "truncated", "not_riff"])
def test_other_files_read_as_io_native_reads_them(tmp_path, case):
    blob = {"stereo": lambda: _wav(ch=2),
            "eight_bit": lambda: _wav(bits=8),
            "float_format": lambda: _wav(fmt=3),
            "truncated": lambda: _wav(data_bytes=4000),
            "not_riff": lambda: b"RIFX" + _wav()[4:]}[case]()
    path = tmp_path / "a.wav"
    path.write_bytes(blob)
    buf = np.zeros(len(blob) + 1, np.uint8)
    try:
        want = read_wav_int16(path)
    except Exception as e:          # noqa: BLE001 - the same error, or none
        with pytest.raises(type(e)):
            read_wav_pcm16(path, buf)
        return
    x, fs = read_wav_pcm16(path, buf)
    assert fs == want[1] and x.dtype == want[0].dtype
    np.testing.assert_array_equal(x, want[0])


class _Echo:
    """An enhancer whose output is its input (a copy, or with ``alias`` the
    arrays it was given), a chunk taking ``wait`` s: it records when each
    chunk's call ran."""

    def __init__(self, wait, alias=False):
        self.wait, self.alias, self.calls = wait, alias, []

    def enhance_batch(self, xs):
        t = time.perf_counter()
        with span("echo"):
            time.sleep(self.wait)
        self.calls.append((t, time.perf_counter()))
        return xs if self.alias else [np.asarray(x, np.int16).copy()
                                      for x in xs]


def _slow(monkeypatch, **waits):
    """The runner's wav reader or writer, ``waits[name]`` s a file slower."""
    for name, wait in waits.items():
        fn = getattr(runner, name)

        def call(*a, fn=fn, wait=wait):
            time.sleep(wait)
            return fn(*a)
        monkeypatch.setattr(runner, name, call)


@contextlib.contextmanager
def _profiled():
    """A profiled session of its own (see ``tests/test_torch_spans.py``)."""
    with span("unseen"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with span("session"):
            pass
        yield


@pytest.mark.parametrize("length_sort,alias", [(True, False),
                                               (False, False), (True, True)])
def test_batch_plan_writes_each_file_its_own_samples(tmp_path, monkeypatch,
                                                     length_sort, alias):
    """Also where the outputs are the read buffers' own views and their
    writes lag the reads."""
    db = tmp_path / "db"
    db.mkdir()
    rng = np.random.default_rng(3)
    want = {}
    for i, n in enumerate(rng.integers(200, 3000, 11)):
        want[f"u{i:02d}"] = rng.integers(-32768, 32768, n).astype(np.int16)
        write_wav_int16(db / f"u{i:02d}.wav", want[f"u{i:02d}"], FS)
    _slow(monkeypatch, write_wav_int16=0.01)
    br = BatchRunner(_Echo(0.01, alias), carry_state=False, verbose=False,
                     force_rewrite=True, length_sort=length_sort)
    for _ in range(2):                      # the second pass reuses buffers
        rep = br.run(db, tmp_path / "out", batch_size=3)
        assert sorted(rep.processed) == [f"{k}.wav" for k in sorted(want)]
        assert rep.seconds_audio == pytest.approx(
            sum(len(v) for v in want.values()) / FS)
        for k, v in want.items():
            got, fs = read_wav_int16(tmp_path / "out" / f"{k}_enh.wav")
            assert fs == FS
            np.testing.assert_array_equal(got, v, err_msg=k)


def test_batch_plan_reads_ahead_and_records_its_spans(tmp_path,
                                                     monkeypatch):
    db = tmp_path / "db"
    db.mkdir()
    for i in range(8):
        write_wav_int16(db / f"u{i}.wav",
                        np.full(400 + 10 * i, i, np.int16), FS)
    _slow(monkeypatch, read_wav_pcm16=0.02, write_wav_int16=0.04)
    enh = _Echo(0.05)
    with _profiled():
        rep = BatchRunner(enh, carry_state=False, verbose=False).run(
            db, tmp_path / "out", batch_size=2)
    got = profiling.spans()
    by = {n: [(a, b) for m, a, b in got if m == n]
          for n in ("runner.io_read", "runner.enhance", "runner.io_write",
                    "echo", "session")}
    assert len(by["session"]) == 1                 # one session throughout
    assert [len(by[n]) for n in ("runner.io_read", "runner.enhance",
                                 "runner.io_write", "echo")] == [4] * 4
    reads = sorted(by["runner.io_read"])
    writes = sorted(by["runner.io_write"])
    # chunk c + 1 is read, and chunk c - 1 written, while the enhancer
    # runs chunk c
    for (t0, t1), (r0, r1) in zip(enh.calls, reads[1:]):
        assert r0 < t1 and r1 > t0
    for (t0, t1), (w0, w1) in zip(enh.calls[1:], writes):
        assert w0 < t1 and w1 > t0
    assert profiling.counters()["runner.files"] == 8
    assert set(rep.timer.stages) == {"io_read", "enhance", "io_write"}
    assert rep.timer.stages["io_read"] == pytest.approx(
        sum(b - a for a, b in reads))
