"""What the program under test records about itself in a traced run: its
spans and counters (``se_snmf_nat_tpu_torch.runtime.profiling``: ``spans``,
``counters``), read after the window on the host's clock.  A program that
records neither gives nothing, and the metrics that read them are left out
of the run's line."""

from __future__ import annotations

import numpy as np

from benchmark.yardstick import covered_many


def _profiling():
    try:
        from se_snmf_nat_tpu_torch.runtime import profiling
    except ImportError:
        return None
    return profiling


def program_spans() -> list | None:
    """The program's (name, start, end) spans of the traced session."""
    fn = getattr(_profiling(), "spans", None)
    return fn() if fn is not None else None


def program_counters() -> dict | None:
    """The program's counters over the traced session."""
    fn = getattr(_profiling(), "counters", None)
    return fn() if fn is not None else None


def stage_ms(run, name: str) -> float | None:
    """ms a request of the program's spans ``name`` that start in the
    window, less the union of the kernel intervals inside them, over the
    window's requests (the harness's spans around each call of its loop)."""
    requests = run.span(run.driver.span)
    got = program_spans()
    if run.trace is None or len(requests) == 0 or not got:
        return None
    sp = np.asarray([(a, b) for n, a, b in got
                     if n == name and run.t0 <= a < run.t1]).reshape(-1, 2)
    if len(sp) == 0:
        return None
    busy = covered_many(run.trace.union, sp)
    return float(((sp[:, 1] - sp[:, 0]) - busy).sum() / len(requests) * 1e3)
