"""The cell ``nat_frame.batch16`` on the CPU at a small size: a run is
correct, reports the rate and prints the head's error uncompared; its
bfloat16 control is not correct; and the faults its limits were set
against are not: one lane zeroed, a refit returning its input, one lane's
output zeroed from frame 100 on.  The driver's head window is the first
``head_frames`` frames of each lane's output."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import compare  # noqa: E402
from benchmark.harness import run_cell  # noqa: E402

CELL = "nat_frame.batch16"
SEED = 2 ** 31 + 777
SHIFT, DELAY = 160, 3
# 200 hops a lane: the fault from frame 100 on covers half of it
SMALL = {"driver": "batch_exact", "lanes": 3, "pool": 6,
         "lengths": {"samples": 32000}, "warmup_calls": 1, "check_calls": 2,
         "head_frames": 48}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(control=False):
    return run_cell(CELL, SEED, 0.3, False, device="cpu", traffic=SMALL,
                    control=control)


def test_a_small_run_is_correct_and_prints_the_head():
    result, lines = _run()
    assert result["correct"], lines
    assert set(result["checks"]) == {"err_median", "err_q75", "err_max"}
    assert any(line.startswith("not compared: err_head_max")
               for line in lines), lines
    assert set(result["metrics"]) == {"audio_s_per_s", "setup_s"}
    json.dumps(result)


def test_the_bfloat16_control_is_not_correct():
    result, lines = _run(control=True)
    ok, _ = compare.judge(result["control"], compare.limits(CELL))
    assert result["correct"] and not ok, lines


def _outputs(monkeypatch, alter):
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    orig = SnmfEnhancer.enhance_batch

    def patched(self, *args, **kwargs):
        return alter(orig(self, *args, **kwargs))
    monkeypatch.setattr(SnmfEnhancer, "enhance_batch", patched)


def _from_frame_100(out):
    y = out[1].copy()
    y[(100 - DELAY) * SHIFT:] = 0
    return [out[0], y] + out[2:]


@pytest.mark.parametrize("fault", ["lane_zeroed", "refit_returns_its_input",
                                   "zeroed_from_frame_100"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    if fault == "refit_returns_its_input":
        from se_snmf_nat_tpu_torch.enhance.engine import Engine
        monkeypatch.setattr(Engine, "_refit",
                            lambda self, target, w0, h0a, r_up, active: w0)
    elif fault == "lane_zeroed":
        _outputs(monkeypatch, lambda out: [np.zeros_like(out[0])] + out[1:])
    else:
        _outputs(monkeypatch, _from_frame_100)
    result, lines = _run()
    assert not result["correct"], lines
    if fault == "zeroed_from_frame_100":
        checks = result["checks"]
        assert checks["err_max"]["value"] > checks["err_max"]["limit"]
        assert checks["err_median"]["value"] <= checks["err_median"]["limit"]


def test_the_head_is_the_first_frames_of_each_lane():
    from types import SimpleNamespace
    from benchmark.drivers.batch_exact import Driver
    got = [np.arange(800, dtype=np.int16), np.arange(800, dtype=np.int16)]
    want = [g.copy() for g in got]
    want[1][(4 - DELAY) * SHIFT:] += 1          # past a head of 4 frames
    drv = Driver.__new__(Driver)
    drv.kept = [(0, got)]
    drv.calls = [[None, None]]
    drv.cell = SimpleNamespace(
        traffic={"head_frames": 4}, delay=DELAY, shift=SHIFT, config={},
        bases=None, reference=SimpleNamespace(
            offline=lambda xs, *a, **k: want))
    nums = drv.numbers(torch.float64, "cpu")
    assert nums["err_head_max"] == 0.0 and nums["err_max"] > 0
