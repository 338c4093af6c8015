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
``StageTimer``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from se_snmf_nat_tpu_torch.io.native import read_wav_int16, write_wav_int16
from se_snmf_nat_tpu_torch.runtime.checkpoint import (
    load_adapted_dictionary, save_adapted_dictionary)
from se_snmf_nat_tpu_torch.runtime.profiling import StageTimer


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

    def _out_path(self, f: Path, out_dir: Path) -> Path:
        return out_dir / f"{f.stem}{self.out_suffix}.wav"

    def run_multichannel(self, db_in: str | Path, db_out: str | Path,
                         ch: int, filegap: int | None = None) -> RunReport:
        """The reference's multichannel campaign shape (run_IMCRA.m:7-30):
        the sorted file list is walked with stride ``filegap`` and each
        group of ``ch`` consecutive files forms ONE multichannel session
        (CHiME per-mic files).  The enhancer must accept (C, n) samples —
        e.g. multichannel.PmwfEnhancer.  Skip-if-exists probes the LAST
        channel's output (the reference's ``fopen(path_denoise(p.ch,:))``);
        enhancers that emit one reference channel write only that file.  A
        group whose files differ in sample rate raises ValueError: its
        channels would be beamformed misaligned."""
        db_in, db_out = Path(db_in), Path(db_out)
        db_out.mkdir(parents=True, exist_ok=True)
        filegap = ch if filegap is None else int(filegap)
        if ch < 1 or filegap < 1:
            raise ValueError("ch and filegap must be >= 1")
        files = sorted(p for p in db_in.iterdir()
                       if p.suffix.lower() == ".wav")
        report = RunReport()
        t0 = time.perf_counter()
        for j in range(0, len(files) - ch + 1, filegap):
            group = files[j: j + ch]
            if (self._out_path(group[-1], db_out).exists()
                    and not self.force_rewrite):
                report.skipped.extend(f.name for f in group)
                continue
            chans, rates = [], []
            with report.timer.stage("io_read"):
                for f in group:
                    x, fs = read_wav_int16(f)
                    chans.append(x)
                    rates.append(fs)
            if len(set(rates)) > 1:
                raise ValueError(
                    "channel group with differing sample rates: "
                    + ", ".join(f"{f.name}={r}" for f, r in zip(group, rates)))
            n = min(len(c) for c in chans)
            stacked = np.stack([c[:n] for c in chans])
            report.seconds_audio += n / rates[0]
            report.timer.add_audio(n / rates[0])
            with report.timer.stage("enhance"):
                y = np.atleast_2d(self.enhancer.enhance(stacked))
            with report.timer.stage("io_write"):
                if y.shape[0] == ch:               # per-channel outputs
                    for f, row in zip(group, y):
                        write_wav_int16(self._out_path(f, db_out), row,
                                        rates[0])
                else:                              # single reference channel
                    write_wav_int16(self._out_path(group[-1], db_out),
                                    y[0], rates[0])
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
            return self.run_multichannel(db_in, db_out, ch, filegap)
        db_in, db_out = Path(db_in), Path(db_out)
        db_out.mkdir(parents=True, exist_ok=True)
        files = sorted(p for p in db_in.iterdir()
                       if p.suffix.lower() == ".wav")
        report = RunReport()
        todo = []
        for f in files:
            if self._out_path(f, db_out).exists() and not self.force_rewrite:
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
            if self.length_sort:
                todo = sorted(todo, key=lambda p: p.stat().st_size)
            for i in range(0, len(todo), batch_size):
                chunk = todo[i: i + batch_size]
                xs, rates = [], []
                with report.timer.stage("io_read"):
                    for f in chunk:
                        x, fs = read_wav_int16(f)
                        xs.append(x)
                        rates.append(fs)   # per-file: mixed-rate dirs must
                        #                    not inherit a chunk-mate's rate
                        report.seconds_audio += len(x) / fs
                        report.timer.add_audio(len(x) / fs)
                with report.timer.stage("enhance"):
                    outs = self.enhancer.enhance_batch(xs)
                with report.timer.stage("io_write"):
                    for f, y, fs in zip(chunk, outs, rates):
                        write_wav_int16(self._out_path(f, db_out), y, fs)
                for f in chunk:
                    report.processed.append(f.name)
                    if self.verbose:
                        print(f"[batch] {f.name}")
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
