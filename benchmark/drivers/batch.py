"""Closed-loop offline enhancement: ``enhance_batch`` calls of a fixed
number of utterances, one after another, each call's int16 PCM on the host
before the next call starts.

The traffic file gives the lanes a call, the size of the utterance pool and
the pool's lengths.  The run's seed draws the utterances and deals the pool
into calls in arrival order; the calls repeat in that cycle.  A reservoir
of ``check_calls`` calls, drawn from the seed, keeps its outputs for the
comparison.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.traffic import inputs

FS = 16000


class Driver:
    span = "enhance_batch"

    def __init__(self, cell):
        self.cell = cell
        t = cell.traffic
        t0 = time.perf_counter()
        self.lanes = int(t["lanes"])
        lens = inputs.lengths(t["lengths"], int(t["pool"]))
        self.pool = inputs.noisy_utterances(lens, cell.seed, cell.device)
        rng = np.random.default_rng([cell.seed, 0])
        self.groups = rng.permutation(len(lens)).reshape(-1, self.lanes)
        self.calls = [[self.pool[i, : lens[i]] for i in g]
                      for g in self.groups]
        self.audio_s = [float(lens[g].sum()) / FS for g in self.groups]
        shift, delay = cell.shift, cell.delay
        self.true_frames = [int(np.sum(lens[g] // shift + delay + 1))
                            for g in self.groups]
        t1 = time.perf_counter()
        self.enh = cell.program()
        t2 = time.perf_counter()
        for c in range(int(t["warmup_calls"])):
            self.enh.enhance_batch(self.calls[c % len(self.calls)],
                                   micro_batch=None)
        self.setup_parts = {"inputs": t1 - t0, "program": t2 - t1,
                            "warm-up": time.perf_counter() - t2}
        self.kept: list[tuple[int, list]] = []
        self.reservoir = np.random.default_rng([cell.seed, 1])
        self.check_calls = int(t["check_calls"])

    def window(self, seconds: float, spans: list) -> dict:
        """Calls until one ends past ``seconds``; the rate is the true audio
        of every call completed over the time from the first call's start
        to the last one's end."""
        audio, frames, failed, i = 0.0, 0, 0, 0
        t0 = time.perf_counter()
        while True:
            g = i % len(self.calls)
            ts = time.perf_counter()
            outs = self.enh.enhance_batch(self.calls[g], micro_batch=None)
            te = time.perf_counter()
            spans.append((self.span, ts, te))
            failed += len(outs) != self.lanes
            self._keep(i, g, outs)
            audio += self.audio_s[g]
            frames += self.true_frames[g]
            i += 1
            if te - t0 >= seconds:
                break
        self.t0, self.t1 = t0, te
        return {"end_to_end": {"audio_s_per_s": audio / (te - t0)},
                "attempted": i * self.lanes, "failed": failed * self.lanes,
                "true_frames": frames,
                "note": f"{i} calls of {self.lanes} utterances, "
                        f"{audio:.3f} audio-s in {te - t0:.6f} s"}

    def _keep(self, i: int, g: int, outs: list) -> None:
        """Reservoir sampling of the calls whose outputs are compared."""
        if len(self.kept) < self.check_calls:
            self.kept.append((g, outs))
            return
        j = int(self.reservoir.integers(0, i + 1))
        if j < self.check_calls:
            self.kept[j] = (g, outs)

    def release(self) -> None:
        del self.enh

    def numbers(self, dtype, device) -> dict[str, float]:
        """The kept calls' outputs against the reference's on the same
        utterances: the reference module's ``offline(xs, config, bases,
        dtype=, device=)`` gives each utterance's int16 output."""
        from benchmark import compare
        got, want = [], []
        for g, outs in self.kept:
            got += outs
            want += self.cell.reference.offline(
                self.calls[g], self.cell.config, self.cell.bases,
                dtype=dtype, device=device)
        return compare.lane_numbers(got, want)
