"""``frame_graph_share.batch`` and ``.stream`` from the program's frame
counters: the share of the frames stepped inside a graph's replay, and
nothing for a program that does not count its frames (one without the
counters, or with no frame stepped in the session)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import load_reader  # noqa: E402
from benchmark.tests.test_perfbench_program_trace import (  # noqa: E402
    CALLS, KERNELS, _program, _run)


@pytest.mark.parametrize("name", ["frame_graph_share.batch",
                                  "frame_graph_share.stream"])
@pytest.mark.parametrize("counters,want", [
    ({"frame.steps": 5552, "frame.steps_graphed": 5552}, 100.0),
    ({"frame.steps": 5552, "frame.steps_graphed": 1388}, 25.0),
    ({"frame.steps": 347}, 0.0),
    ({"batch.lanes": 16, "batch.lanes_int16": 16}, None),
    ({"frame.steps": 0, "frame.steps_graphed": 0}, None),
    (None, None),
])
def test_frame_graph_share_from_the_frame_counters(monkeypatch, name,
                                                   counters, want):
    _program(monkeypatch, counters=counters)
    got = load_reader(name)(_run("enhance_batch", CALLS, KERNELS))
    assert got == (want if want is None else pytest.approx(want))
