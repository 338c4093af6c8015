"""Directory-batch enhancement runner (port of the reference package's
``runtime/runner.py``).

Reference: run_ntf_sep_RT.m / run_IMCRA.m — loop a DB directory, skip
outputs that already exist (unless forced), thread the adapted noise
dictionary through consecutive files via B_D_u, emit progress lines.

Two execution plans:
  * sequential (reference semantics): files in order, dictionary state
    chained file-to-file (run_ntf_sep_RT.m:28-38,136-139);
  * batched: utterances as the lanes of ``enhance_batch``, each starting
    from the same initial state — higher throughput, with the cross-file
    chaining off (SURVEY §7.3).

The runner runs on its enhancer's device and names none of its own.  Wav
files go through the port's ``io/native`` (the C++ library when g++ can
build it, the byte-identical Python paths otherwise); the B_D_u file is the
npz of ``runtime/checkpoint``, which both packages read.  Each plan times
its stages (``io_read``, ``enhance``, ``io_write``) in the report's
``StageTimer`` and adds the files it reads to the host counter
``runner.files`` (``runtime.profiling``).

The batch plan keeps the enhancer fed: while it runs a chunk, one thread
reads the next chunk and ``WRITERS`` threads write the last one's
outputs.  It reads a mono 16-bit PCM file with one open and one read into
a byte buffer the runner keeps (three, used in turn by the chunks), and
hands the enhancer int16 views of it, which ``enhance_batch`` sends up as
they are; any other file goes through ``io/native`` as before.
"""

from __future__ import annotations

import struct
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from se_snmf_nat_tpu_torch.io.native import read_wav_int16, write_wav_int16
from se_snmf_nat_tpu_torch.runtime.checkpoint import (
    load_adapted_dictionary, save_adapted_dictionary)
from se_snmf_nat_tpu_torch.runtime.profiling import (StageTimer, count,
                                                     record)

FILES = "runner.files"      # the host counter of the files read
WRITERS = 2                 # the batch plan's threads writing outputs


def read_wav_pcm16(path: Path, buf: np.ndarray):
    """A mono 16-bit PCM wav's samples as an int16 view of ``buf`` (a uint8
    array at least the file's size), and its rate, with one open and one
    read; the header is walked as ``native/snmfio.cpp``'s ``read_header``
    walks it.  Any other file (more channels, another format, a header or
    data the read did not hold) gives ``io/native``'s ``read_wav_int16``:
    its float64 samples, or its error."""
    with open(path, "rb", buffering=0) as fh:
        got = fh.readinto(buf)
    b = buf[:got].data
    if got >= 12 and b[:4] == b"RIFF" and b[8:12] == b"WAVE":
        pos, fmt = 12, None
        while pos + 8 <= got:
            cid, sz = bytes(b[pos: pos + 4]), struct.unpack_from(
                "<I", b, pos + 4)[0]
            pos += 8
            if cid == b"fmt ":
                if sz < 16 or pos + 16 > got:
                    break
                code, ch, fs = struct.unpack_from("<HHI", b, pos)
                fmt = (code, ch, fs, struct.unpack_from("<H", b, pos + 14)[0])
                pos += sz
            elif cid == b"data":
                if fmt is None or fmt[:2] != (1, 1) or fmt[3] != 16:
                    break
                n = sz // 2
                if pos + 2 * n > got:
                    break
                return buf[pos: pos + 2 * n].view(np.int16), fmt[2]
            else:
                pos += sz + (sz & 1)
    return read_wav_int16(path)


def _timed(timer: StageTimer, name: str, start: float, end: float) -> None:
    """A stage of ``timer`` timed on another thread, added (and its span
    recorded) on this one."""
    timer.stages[name] = timer.stages.get(name, 0.0) + end - start
    record(f"runner.{name}", start, end)


@dataclass
class RunReport:
    processed: list[str] = field(default_factory=list)
    skipped: list[str] = field(default_factory=list)
    seconds_audio: float = 0.0
    seconds_wall: float = 0.0
    timer: StageTimer = field(default_factory=StageTimer)

    @property
    def realtime_factor(self) -> float:
        return (self.seconds_audio / self.seconds_wall if self.seconds_wall
                else 0.0)


class BatchRunner:
    """Runs an enhancer over a wav directory tree."""

    def __init__(self, enhancer, *, carry_state: bool = True,
                 force_rewrite: bool = False, out_suffix: str = "_enh",
                 state_path: str | Path | None = None,
                 verbose: bool = True, length_sort: bool = True):
        self.enhancer = enhancer
        self.carry_state = carry_state
        self.force_rewrite = force_rewrite
        self.out_suffix = out_suffix
        self.state_path = Path(state_path) if state_path else None
        self.verbose = verbose
        # length_sort (batch path only): chunk files in ascending size
        # order so each batched call pads to a chunk-local maximum.  Only
        # the chunking changes; file writes keep their names, and in
        # float64 every per-file output is the unsorted run's.
        self.length_sort = bool(length_sort)
        self._bufs = [None] * 3         # the batch plan's read buffers

    def _out_path(self, f: Path, out_dir: Path) -> Path:
        return out_dir / f"{f.stem}{self.out_suffix}.wav"

    def run_multichannel(self, db_in: str | Path, db_out: str | Path,
                         ch: int, filegap: int | None = None,
                         batch_size: int = 1) -> RunReport:
        """The reference's multichannel campaign shape (run_IMCRA.m:7-30):
        the sorted file list is walked with stride ``filegap`` and each
        group of ``ch`` consecutive files forms ONE multichannel session
        (CHiME per-mic files).  The enhancer must accept (C, n) samples —
        e.g. multichannel.PmwfEnhancer.  Skip-if-exists probes the LAST
        channel's output (the reference's ``fopen(path_denoise(p.ch,:))``);
        enhancers that emit one reference channel write only that file.  A
        group whose files differ in sample rate raises ValueError: its
        channels would be beamformed misaligned.  With ``batch_size`` > 1
        and an enhancer that has ``enhance_batch``, the groups go through it
        ``batch_size`` at a time as its lanes (each lane's output is the
        group's own), else one ``enhance`` a group."""
        db_in, db_out = Path(db_in), Path(db_out)
        db_out.mkdir(parents=True, exist_ok=True)
        filegap = ch if filegap is None else int(filegap)
        if ch < 1 or filegap < 1:
            raise ValueError("ch and filegap must be >= 1")
        files = sorted(p for p in db_in.iterdir()
                       if p.suffix.lower() == ".wav")
        report = RunReport()
        t0 = time.perf_counter()
        todo = []
        for j in range(0, len(files) - ch + 1, filegap):
            group = files[j: j + ch]
            if (self._out_path(group[-1], db_out).exists()
                    and not self.force_rewrite):
                report.skipped.extend(f.name for f in group)
            else:
                todo.append(group)
        batched = batch_size > 1 and hasattr(self.enhancer, "enhance_batch")
        step = batch_size if batched else 1
        for c in range(0, len(todo), step):
            chunk = todo[c: c + step]
            stacks, fss = [], []
            with report.timer.stage("io_read"):
                for group in chunk:
                    chans, rates = [], []
                    for f in group:
                        x, fs = read_wav_int16(f)
                        chans.append(x)
                        rates.append(fs)
                    count(FILES, len(group))
                    if len(set(rates)) > 1:
                        raise ValueError(
                            "channel group with differing sample rates: "
                            + ", ".join(f"{f.name}={r}"
                                        for f, r in zip(group, rates)))
                    n = min(len(x) for x in chans)
                    stacks.append(np.stack([x[:n] for x in chans]))
                    fss.append(rates[0])
            for stacked, fs in zip(stacks, fss):
                report.seconds_audio += stacked.shape[1] / fs
                report.timer.add_audio(stacked.shape[1] / fs)
            with report.timer.stage("enhance"):
                ys = (self.enhancer.enhance_batch(stacks) if batched
                      else [self.enhancer.enhance(stacks[0])])
            with report.timer.stage("io_write"):
                for group, y, fs in zip(chunk, ys, fss):
                    y = np.atleast_2d(y)
                    if y.shape[0] == ch:               # per-channel outputs
                        for f, row in zip(group, y):
                            write_wav_int16(self._out_path(f, db_out), row,
                                            fs)
                    else:                          # single reference channel
                        write_wav_int16(self._out_path(group[-1], db_out),
                                        y[0], fs)
            for group in chunk:
                report.processed.extend(f.name for f in group)
                if self.verbose:
                    print(f"[mc x{ch}] {group[-1].name}")
        report.seconds_wall = time.perf_counter() - t0
        return report

    def run(self, db_in: str | Path, db_out: str | Path,
            batch_size: int = 1, ch: int = 1,
            filegap: int | None = None) -> RunReport:
        if ch < 1:
            raise ValueError("ch must be >= 1")
        if ch > 1:
            return self.run_multichannel(db_in, db_out, ch, filegap,
                                         batch_size)
        db_in, db_out = Path(db_in), Path(db_out)
        db_out.mkdir(parents=True, exist_ok=True)
        files = sorted(p for p in db_in.iterdir()
                       if p.suffix.lower() == ".wav")
        report = RunReport()
        todo = []
        for f in files:
            if not self.force_rewrite and self._out_path(f, db_out).exists():
                report.skipped.append(f.name)      # run_ntf_sep_RT.m:35-40
            else:
                todo.append(f)

        t0 = time.perf_counter()
        # Batch plan whenever carry is off OR the enhancer has no
        # dictionary head to carry: for MS/IMCRA the sequential plan already
        # runs one-shot per file (no reference-sanctioned cross-file state),
        # so batching them changes no output.
        init0 = self.enhancer.initial_state() \
            if (hasattr(self.enhancer, "initial_state")
                and (batch_size > 1 or self.carry_state)) else None
        batchable = not self.carry_state or not hasattr(init0, "b_d_head")
        if batch_size > 1 and batchable \
                and hasattr(self.enhancer, "enhance_batch"):
            sizes = {f: f.stat().st_size for f in todo}
            if self.length_sort:
                todo = sorted(todo, key=sizes.__getitem__)
            chunks = [todo[i: i + batch_size]
                      for i in range(0, len(todo), batch_size)]

            def read(c):
                """Chunk c's samples and rates (per file: a mixed-rate
                directory must not give a file a chunk-mate's rate), read
                into buffer c % 3, whose chunk c - 3 was enhanced and its
                outputs written before this read was queued."""
                t = time.perf_counter()
                need = sum(sizes[f] + 1 for f in chunks[c])
                buf = self._bufs[c % 3]
                if buf is None or buf.size < need:
                    buf = self._bufs[c % 3] = np.empty(need + need // 4,
                                                       np.uint8)
                xs, rates, at = [], [], 0
                for f in chunks[c]:
                    x, fs = read_wav_pcm16(f, buf[at: at + sizes[f] + 1])
                    at += sizes[f] + 1 + (sizes[f] + 1) % 2
                    xs.append(x)
                    rates.append(fs)
                return xs, rates, t, time.perf_counter()

            def write(jobs):
                t = time.perf_counter()
                for f, y, fs in jobs:
                    write_wav_int16(self._out_path(f, db_out), y, fs)
                return t, time.perf_counter()

            def written(c, futs):
                """Chunk c's writes done: their span, from the first start
                to the last end, and its files processed."""
                times = [fut.result() for fut in futs]
                _timed(report.timer, "io_write", min(a for a, _ in times),
                       max(b for _, b in times))
                for f in chunks[c]:
                    report.processed.append(f.name)
                    if self.verbose:
                        print(f"[batch] {f.name}")

            # one thread reads chunk c + 1, and WRITERS threads write chunk
            # c - 1's outputs, while the enhancer runs chunk c
            with ThreadPoolExecutor(1, "runner-read") as reader, \
                    ThreadPoolExecutor(WRITERS, "runner-write") as writer:
                reading = reader.submit(read, 0) if chunks else None
                writing = None
                for c in range(len(chunks)):
                    xs, rates, t0, t1 = reading.result()
                    _timed(report.timer, "io_read", t0, t1)
                    count(FILES, len(xs))
                    for x, fs in zip(xs, rates):
                        report.seconds_audio += len(x) / fs
                        report.timer.add_audio(len(x) / fs)
                    if c + 1 < len(chunks):
                        reading = reader.submit(read, c + 1)
                    with report.timer.stage("enhance"):
                        outs = self.enhancer.enhance_batch(xs)
                    if writing is not None:
                        written(c - 1, writing)
                    jobs = list(zip(chunks[c], outs, rates))
                    writing = [writer.submit(write, jobs[k::WRITERS])
                               for k in range(min(WRITERS, len(jobs)))]
                if writing is not None:
                    written(len(chunks) - 1, writing)
        else:
            # Cross-file carry mirrors the reference's B_D_u exactly: only
            # the adapted noise-dictionary head survives a file boundary;
            # every other buffer re-initializes per file (init_buff per file
            # + B_D_u load, NTF_sep_event_RT.m:28-46).  Enhancers without a
            # dictionary head (MS/IMCRA) have no reference-sanctioned
            # cross-file state — threading their stream state would mix one
            # file's OLA tail into the next — so they run one-shot per file.
            init = init0 if self.carry_state else None
            dict_carry = self.carry_state and hasattr(init, "b_d_head")
            state = init if dict_carry else None
            if dict_carry and self.state_path and self.state_path.exists():
                state = load_adapted_dictionary(
                    self.state_path, init, self.enhancer.dtype)
            for f in todo:
                with report.timer.stage("io_read"):
                    x, fs = read_wav_int16(f)
                    count(FILES, 1)
                report.seconds_audio += len(x) / fs
                report.timer.add_audio(len(x) / fs)
                with report.timer.stage("enhance"):
                    if dict_carry:
                        y, state_out = self.enhancer.enhance(
                            x, state=state, return_state=True)
                        state = init._replace(b_d_head=state_out.b_d_head)
                    else:
                        y = self.enhancer.enhance(x)
                with report.timer.stage("io_write"):
                    write_wav_int16(self._out_path(f, db_out), y, fs)
                report.processed.append(f.name)
                if self.verbose:
                    print(f"[seq] {f.name}")
                if dict_carry and self.state_path:
                    save_adapted_dictionary(self.state_path, state)
        report.seconds_wall = time.perf_counter() - t0
        return report
