"""Closed-loop offline enhancement of multichannel utterances: the batch
loop of ``drivers/batch.py`` over (channels, n) lanes from
``traffic/inputs_mc.tablet_mixtures``.

The traffic file gives the lanes a call, the size of the pool, the pool's
lengths and the channels.  The run's seed draws the utterances and deals
the pool into calls in arrival order; the calls repeat in that cycle.  The
comparison holds every output channel of every lane of the kept calls to
the reference's (one error a lane over all its channels).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.drivers import batch
from benchmark.traffic import inputs, inputs_mc


class Driver(batch.Driver):

    def __init__(self, cell):
        self.cell = cell
        t = cell.traffic
        t0 = time.perf_counter()
        self.lanes = int(t["lanes"])
        if int(t["channels"]) != len(inputs_mc.TABLET):
            raise ValueError("the tablet mixtures have "
                             f"{len(inputs_mc.TABLET)} channels")
        lens = inputs.lengths(t["lengths"], int(t["pool"]))
        self.pool = inputs_mc.tablet_mixtures(lens, cell.seed, cell.device)
        rng = np.random.default_rng([cell.seed, 0])
        self.groups = rng.permutation(len(lens)).reshape(-1, self.lanes)
        self.calls = [[self.pool[i, :, : lens[i]] for i in g]
                      for g in self.groups]
        self.audio_s = [float(lens[g].sum()) / batch.FS for g in self.groups]
        self.lane_frames = [lens[g] // cell.shift + cell.delay + 1
                            for g in self.groups]
        self.true_frames = [int(f.sum()) for f in self.lane_frames]
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

    def window_lane_frames(self, n_calls: int) -> np.ndarray:
        """The true frames of every lane of the window's first ``n_calls``
        calls (a window runs the calls in their cycle from the first)."""
        return np.concatenate([self.lane_frames[i % len(self.calls)]
                               for i in range(n_calls)])
