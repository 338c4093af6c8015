"""``int16_lane_share`` from the program's lane counters: the share of the
real lanes sent as int16, and nothing for a program that does not count
its lanes (one without the counters, or with no lanes in the session)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import load_reader  # noqa: E402
from benchmark.tests.test_perfbench_program_trace import (  # noqa: E402
    CALLS, KERNELS, _program, _run)


@pytest.mark.parametrize("counters,want", [
    ({"batch.lanes": 128, "batch.lanes_int16": 128}, 100.0),
    ({"batch.lanes": 128, "batch.lanes_int16": 64}, 50.0),
    ({"batch.lanes": 64, "batch.lanes_int16": 0}, 0.0),
    ({"batch.frames_true": 347, "batch.frames_computed": 352}, None),
    ({"batch.lanes": 0, "batch.lanes_int16": 0}, None),
    (None, None),
])
def test_int16_lane_share_from_the_lane_counters(monkeypatch, counters,
                                                 want):
    _program(monkeypatch, counters=counters)
    got = load_reader("int16_lane_share")(_run("enhance_batch", CALLS,
                                               KERNELS))
    assert got == (want if want is None else pytest.approx(want))
