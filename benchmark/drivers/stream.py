"""Open-loop live audio: a tick of ``tick_hops`` hops a lane is due every
``tick_hops`` hop periods on the audio clock, whether or not the last tick
has finished.  ``api`` is ``fleet`` (one ``MultiStreamSession`` of
``lanes`` lanes, pushed (lanes, n) samples a tick) or ``session`` (one
``StreamingSession``, pushed n samples).

Each lane plays its own utterance, drawn from the seed, in a loop, from a
phase of it drawn from the seed: a stream may open in the noise before the
speech or inside the speech.  A request is one push: its latency runs from
when its audio was due to when its int16 PCM is back on the host, so a
late tick delays the ticks behind it.  The samples of a tick are cut out
before it is due.

The comparison.  The warm-up runs on a session of its own, built as the
window's is and dropped before the window, so the session the window drives
starts from the program's initial state at the window's first tick.  The
reference then runs each checked lane (drawn from the seed) from the
stream's first sample, from the state it works out itself from the
configuration and the dictionaries, over the first ``check_frames``
frames, and is held to the int16 PCM the program emitted for them, lane by
lane or hop by hop (``benchmark/compare.py``).  That horizon holds the
start-up frames, the first refits of the adapted noise columns and the
first rings; past it the plan's thresholds
(its stops at a relative cost of 1e-3, the triggers, the refit's columns),
decided on float32 values, may flip on rounding and send a lane's history
away from float64's for good.
"""

from __future__ import annotations

import math
import time

import numpy as np

from benchmark.traffic import inputs


def wait(due: float) -> None:
    """Until ``due`` on the host's clock, spinning: a thread put to sleep
    wakes late and on a core gone cold, and its next push is slower (on an
    H100 host the microphone's median read 3.92-3.94 ms after sleeping
    through all but 2 ms of each wait, 3.63-3.64 ms spinning)."""
    while time.perf_counter() < due:
        pass


class Driver:

    def __init__(self, cell):
        self.cell = cell
        t = cell.traffic
        t0 = time.perf_counter()
        self.api = t["api"]
        self.span = f"{self.api}.push"
        self.lanes = int(t["lanes"]) if self.api == "fleet" else 1
        self.tick_hops = int(t["tick_hops"])
        self.n = self.tick_hops * cell.shift
        self.tick_s = self.n / cell.fs
        u = int(t["utterance_samples"])
        self.utts = inputs.noisy_utterances([u] * self.lanes, cell.seed,
                                            cell.device)
        rng = np.random.default_rng([cell.seed, 2])
        self.phase = rng.integers(0, u, self.lanes)
        k = min(int(t["check_lanes"]), self.lanes)
        self.checked = np.sort(rng.choice(self.lanes, k, replace=False))
        self.check_frames = int(t["check_frames"])
        self.check_ticks = math.ceil(self.check_frames / self.tick_hops)
        t1 = time.perf_counter()
        self.enh = cell.program()
        t2 = time.perf_counter()
        self.sess = self._session()
        for k in range(int(t["warmup_ticks"])):
            self.sess.push(self._tick_samples(k))
        self.sess = self._session()
        self.outs: list[np.ndarray] = []
        self.setup_parts = {"inputs": t1 - t0, "program": t2 - t1,
                            "warm-up": time.perf_counter() - t2}

    def _session(self):
        t = self.cell.traffic
        if self.api == "fleet":
            from se_snmf_nat_tpu_torch.stream.serving import (
                MultiStreamSession)
            return MultiStreamSession(self.enh, self.lanes,
                                      block_frames=int(t["block_frames"]),
                                      wire=t["wire"])
        from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession
        return StreamingSession(self.enh,
                                block_frames=int(t["block_frames"]))

    def _samples(self, start: int, n: int) -> np.ndarray:
        """Samples start .. start + n of every lane's looped stream."""
        idx = (self.phase[:, None] + start + np.arange(n)[None, :]) \
            % self.utts.shape[1]
        return np.take_along_axis(self.utts, idx, axis=1)

    def _tick_samples(self, k: int) -> np.ndarray:
        x = self._samples(k * self.n, self.n)
        return x if self.api == "fleet" else x[0]

    def window(self, seconds: float, spans: list) -> dict:
        """Ticks due in [0, seconds) after the window opens, each pushed at
        its due time or, when late, at once."""
        n_ticks = math.ceil(seconds / self.tick_s)
        lat, late, service = [], [], []
        t0 = time.perf_counter()
        for k in range(n_ticks):
            due = t0 + k * self.tick_s
            x = self._tick_samples(k)
            now = time.perf_counter()
            if now < due:
                wait(due)
                spans.append(("wait_audio", now, time.perf_counter()))
            ts = time.perf_counter()
            y = self.sess.push(x)
            te = time.perf_counter()
            if k < self.check_ticks:
                self.outs.append(y.reshape(self.lanes, -1)[self.checked])
            spans.append((self.span, ts, te))
            lat.append(te - due)
            late.append(ts - due)
            service.append((due, te))
        self.t0, self.t1 = t0, te
        lat_ms = np.asarray(lat) * 1e3
        late_ms = np.asarray(late) * 1e3
        return {"end_to_end": {
                    "latency_ms_p95": float(np.percentile(lat_ms, 95)),
                    "latency_ms_p50": float(np.percentile(lat_ms, 50))},
                "attempted": n_ticks, "failed": 0, "service": service,
                "note": f"{n_ticks} requests of {self.tick_hops} hops x "
                        f"{self.lanes} lanes; the generator ran late by "
                        f"{float(np.mean(late_ms)):.3f} ms on average, "
                        f"{float(np.max(late_ms)):.3f} ms at most, "
                        f"{float(np.percentile(late_ms, 95)):.3f} ms at p95; "
                        f"the first ticks took "
                        f"{', '.join(f'{v:.3f}' for v in lat_ms[:3])} ms"}

    def release(self) -> None:
        del self.sess, self.enh

    def numbers(self, dtype, device) -> dict[str, float]:
        """The checked lanes' first ``check_frames`` frames against the
        reference's from the same samples: the reference module's
        ``live(x, n_frames, config, bases, dtype=, device=)`` gives the
        int16 hops they emit and the refits that ran."""
        from benchmark import compare
        shift, h = self.cell.shift, self.check_frames
        n_out = (h - self.cell.delay) * shift
        got = np.concatenate(self.outs, axis=1)[:, :n_out]
        x = self._samples(0, h * shift)[self.checked]
        want, refits = self.cell.reference.live(
            x, h, self.cell.config, self.cell.bases, dtype=dtype,
            device=device)
        return dict(compare.lane_numbers(list(got), list(want)),
                    **compare.hop_numbers(list(got), list(want), shift),
                    refits=float(refits))
