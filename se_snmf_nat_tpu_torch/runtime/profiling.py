"""Tracing and stage timers of the port (counterpart of the first half of
the reference package's ``runtime/profiling.py``; its ``measure_*``
helpers belong to the JAX package's ``bench`` command and are not
ported).

  * ``trace(dir)``     — a ``torch.profiler.profile`` around the block, CPU
                         activities and, where a card is present, CUDA
                         ones; a Chrome trace lands in ``dir`` (open it in
                         Perfetto or ``chrome://tracing``).
  * ``StageTimer``     — named wall-clock stages with audio-second
                         accounting (a copy of the reference's).
  * ``annotate(name)`` — ``torch.profiler.record_function``, so stages show
                         up named in a trace.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


@dataclass
class StageTimer:
    """Accumulates wall time per named stage plus processed audio seconds."""

    stages: dict = field(default_factory=dict)
    audio_seconds: float = 0.0

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) \
                + time.perf_counter() - t0

    def add_audio(self, seconds: float) -> None:
        self.audio_seconds += seconds

    @property
    def total(self) -> float:
        return sum(self.stages.values())

    def report(self) -> dict:
        out = {
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.total, 4),
            "audio_seconds_per_s": round(
                self.audio_seconds / self.total, 2) if self.total else 0.0,
            "stages": {k: round(v, 4) for k, v in self.stages.items()},
        }
        return out

    def json(self) -> str:
        return json.dumps(self.report())
