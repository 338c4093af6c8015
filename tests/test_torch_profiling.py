"""The port's stage timers and traces (``runtime/profiling.py``):
``StageTimer`` against the JAX package's on the same stages and audio, and
``trace`` writing a Chrome trace of a CPU run into its directory (the CUDA
activities are added only where a card is present)."""

import json

import pytest
import torch

from se_snmf_nat_tpu.runtime.profiling import StageTimer as JStageTimer
from se_snmf_nat_tpu_torch.runtime import span, trace
from se_snmf_nat_tpu_torch.runtime.profiling import StageTimer


def _fill(timer):
    for name in ("io_read", "enhance", "io_read"):
        with timer.stage(name):
            sum(range(20000))
    timer.add_audio(1.25)
    timer.add_audio(2.0)
    return timer


def test_stage_timer_matches_reference():
    port, ref = _fill(StageTimer()), _fill(JStageTimer())
    assert list(port.stages) == list(ref.stages) == ["io_read", "enhance"]
    assert port.audio_seconds == ref.audio_seconds == 3.25
    # the same accounting on the same stage times
    ref.stages = dict(port.stages)
    assert port.total == ref.total
    assert port.report() == ref.report()
    assert json.loads(port.json()) == json.loads(ref.json())
    assert port.report()["audio_seconds_per_s"] == pytest.approx(
        3.25 / port.total, rel=1e-2)


def test_stage_timer_empty_and_raising_stage():
    t = StageTimer()
    assert t.report()["audio_seconds_per_s"] == 0.0
    with pytest.raises(ValueError):
        with t.stage("boom"):
            raise ValueError("inside a stage")
    assert t.stages["boom"] >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "trace"
    a = torch.arange(256.0)
    with trace(str(out)):
        with span("probe"):
            float((a * a).sum())
    files = [p for p in out.rglob("*") if p.is_file()]
    assert files, "profiler trace produced no artifacts"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "probe" for e in events)
